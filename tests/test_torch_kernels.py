"""The port's kernel modules against the JAX Pallas kernels.

Each kernel module's plain PyTorch version (what its wrapper runs for a CPU
tensor) is held against the Pallas kernel as the JAX tests run it on the
CPU (``repro.kernels.ops.*`` with ``interpret=True``), on the same NumPy
inputs, at M³ViT main-path shapes and at ragged ones.  Tolerances
(``repro_torch.kernels.compare``): float32 ``1e-5 + 1e-5·|ref|``; bf16 one
ulp plus that float32 tolerance (the two float32 sums before rounding
differ by it, which shows only near zero); one table step more where a
LUT epilogue's pre-activation sits on an index half-step; the LUT
activation bit-exact; rows past a queue exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jk
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import gelu_lut as kgl
from repro_torch.kernels import launch_counts
from repro_torch.kernels import moe_gemm as kmg
from repro_torch.kernels import unified_linear as kul
from repro_torch.kernels.compare import kernel_tolerance, within_tolerance
from repro_torch.bridge import tensor_from_numpy

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor of ``dtype``."""
    j = jnp.asarray(a, DTYPES[dtype][0])
    return j, tensor_from_numpy(np.asarray(jax.device_get(j)))


def to_torch(j) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(jax.device_get(j)))


def assert_close(got, want, dtype, **kw):
    tol = kernel_tolerance(got, want, dtype, **kw)
    err = (got.float() - want.float()).abs()
    bad = err > tol
    assert within_tolerance(got, want, dtype, **kw), (
        f"{int(bad.sum())} of {err.numel()} elements out of tolerance; "
        f"max err {float(err.max())}")


# ------------------------------------------------------------ gelu_lut


def _lut_inputs(rng, shape):
    # no subnormals: XLA on the CPU flushes them to zero, PyTorch keeps them
    x = rng.normal(scale=3.0, size=shape).astype(np.float32).reshape(-1)
    special = np.array(
        [np.inf, -np.inf, np.nan, 0.0, -0.0, 8.0, -8.0, 7.998, 9.5, -12.0,
         1e30, -1e30, 3.4e38, 1e-30, -1e-30]
        # exact half-steps of the 2^-8 index: half-to-even rounding
        + [(k + 0.5) / 256 for k in range(0, 40)]
        + [-(k + 0.5) / 256 for k in range(0, 40)], np.float32)
    x[:special.size] = special
    return x.reshape(shape)


@pytest.mark.parametrize("shape", [(2, 16, 68, 768), (1001,), (3, 5, 7)],
                         ids=["main_path", "ragged_1d", "ragged_3d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["gelu", "silu"])
def test_lut_activation_bit_exact(rng, shape, dtype, kind):
    xj, xt = pair(_lut_inputs(rng, shape), dtype)
    want = to_torch(jk.lut_activation(xj, kind, interpret=True))
    got = kgl.lut_activation(xt, kind)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


# ------------------------------------------------------------ unified_linear

# main-path (M, K, N, bias, activation) at B = 2 images (M = 256 tokens)
LINEAR_CASES = {
    "patch_embed": (256, 768, 192, True, None),
    "qkvo": (256, 192, 192, False, None),
    "mlp_up_lut": (256, 192, 768, True, "gelu_lut"),
    "mlp_down": (256, 768, 192, True, None),
    "semseg_head": (256, 192, 4864, True, None),
    "depth_head": (256, 192, 256, True, None),
    "ragged_relu": (70, 33, 200, True, "relu"),
    "ragged_gelu": (1, 500, 33, True, "gelu"),
    "ragged_silu": (67, 129, 65, False, "silu"),
    "ragged_silu_lut": (45, 96, 130, True, "silu_lut"),
}


@pytest.mark.parametrize("case", list(LINEAR_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unified_linear_plain_matches_pallas(rng, case, dtype):
    m, k, n, has_bias, act = LINEAR_CASES[case]
    use_lut = act is not None and act.endswith("_lut")
    act = act.removesuffix("_lut") if act else None
    xj, xt = pair(rng.normal(size=(m, k)), dtype)
    wj, wt = pair(rng.normal(size=(k, n)) / np.sqrt(k), dtype)
    bj = bt = None
    if has_bias:
        bj, bt = pair(rng.normal(size=(n,)) * 0.1, "float32")
    want = to_torch(jk.unified_linear(xj, wj, bj, activation=act,
                                      use_lut=use_lut, interpret=True))
    got = kul.unified_linear(xt, wt, bt, activation=act, use_lut=use_lut)
    assert got.dtype == xt.dtype and got.shape == (m, n)
    pre = kul.unified_linear_plain(xt.float(), wt.float(), bt) \
        if use_lut else None
    assert_close(got, want, DTYPES[dtype][1], lut_pre=pre,
                 kind=act or "gelu")


def test_unified_linear_flattens_leading_dims(rng):
    x = torch.from_numpy(rng.normal(size=(2, 3, 5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 7)).astype(np.float32))
    got = kul.unified_linear(x, w)
    assert got.shape == (2, 3, 5, 7)
    torch.testing.assert_close(got, x @ w, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ flash_attention

# (B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset)
ATTN_CASES = {
    "main_path": (2, 3, 3, 128, 128, 64, False, None, 0),
    "causal_window_gqa_offset": (1, 4, 2, 33, 77, 48, True, 9, 40),
    "gqa_causal_ragged": (2, 6, 3, 100, 100, 32, True, None, 0),
    "window_noncausal": (1, 2, 1, 65, 65, 16, False, 7, 0),
    "fully_masked_rows": (1, 2, 2, 8, 20, 8, True, 2, -4),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(rng, case, dtype):
    b, hq, hkv, sq, skv, d, causal, window, q_offset = ATTN_CASES[case]
    qj, qt = pair(rng.normal(size=(b, hq, sq, d)), dtype)
    kj, kt = pair(rng.normal(size=(b, hkv, skv, d)), dtype)
    vj, vt = pair(rng.normal(size=(b, hkv, skv, d)), dtype)
    want = to_torch(jk.flash_attention(qj, kj, vj, causal=causal,
                                       window=window, q_offset=q_offset,
                                       interpret=True))
    got = kfa.flash_attention(qt, kt, vt, causal=causal, window=window,
                              q_offset=q_offset)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    assert_close(got, want, DTYPES[dtype][1])


def test_flash_attention_fully_masked_rows_are_zero(rng):
    q = torch.from_numpy(rng.normal(size=(1, 1, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 1, 6, 8)).astype(np.float32))
    # query 0 sits at position -3: causal leaves it no key
    out = kfa.flash_attention(q, k, k, causal=True, q_offset=-3)
    assert (out[0, 0, :3] == 0).all() and (out[0, 0, 3] != 0).any()


# ------------------------------------------------------------ moe_gemm

# (E, C, D, F, sizes)
MOE_CASES = {
    "w1_main_path": (16, 68, 192, 768,
                     [0, 68, 31, 2, 0, 45, 68, 12, 0, 7, 33, 60, 1, 0, 20, 5]),
    "w2_main_path": (16, 68, 768, 192,
                     [3, 0, 68, 17, 40, 0, 0, 68, 9, 22, 1, 50, 0, 64, 11, 2]),
    "ragged": (5, 13, 37, 29, [0, 13, 7, 0, 1]),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gemm_plain_matches_pallas(rng, case, dtype):
    e, c, d, f, sizes = MOE_CASES[case]
    # the queue tails hold garbage: the contract zeroes them anyway
    bj, bt = pair(rng.normal(size=(e, c, d)), dtype)
    wj, wt = pair(rng.normal(size=(e, d, f)) / np.sqrt(d), dtype)
    sj = jnp.asarray(sizes, jnp.int32)
    st = torch.tensor(sizes, dtype=torch.int32)
    want = to_torch(jk.moe_gemm(bj, wj, sj, interpret=True))
    got = kmg.moe_gemm(bt, wt, st)
    assert got.dtype == bt.dtype and got.shape == (e, c, f)
    assert_close(got, want, DTYPES[dtype][1])
    for i, s in enumerate(sizes):      # exact zeros: +0.0, not just == 0
        bits = got[i, s:].float().numpy().view(np.uint32)
        assert (bits == 0).all()


def test_moe_gemm_folds_groups(rng):
    """(G, E, C, D) with (G, E) sizes equals G separate (E, C, D) calls."""
    g, e, c, d, f = 3, 4, 9, 16, 24
    buf = torch.from_numpy(rng.normal(size=(g, e, c, d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(e, d, f)).astype(np.float32))
    sizes = torch.from_numpy(rng.integers(0, c + 1, size=(g, e))
                             .astype(np.int32))
    out = kmg.moe_gemm(buf, w, sizes)
    for i in range(g):
        torch.testing.assert_close(out[i], kmg.moe_gemm(buf[i], w, sizes[i]),
                                   rtol=0, atol=0)


# ------------------------------------------------------------ wrappers


def test_cpu_tensors_run_plain_versions_without_launching(rng):
    before = launch_counts()
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    kul.unified_linear(x, x.T.contiguous(), activation="gelu", use_lut=True)
    kgl.lut_activation(x)
    kfa.flash_attention(x[None, None], x[None, None], x[None, None])
    kmg.moe_gemm(x[None], x.T.contiguous()[None],
                 torch.tensor([2], dtype=torch.int32))
    assert launch_counts() == before


@pytest.mark.parametrize("name", ["linear", "lut", "attention", "moe"])
def test_wrappers_refuse_other_devices(name):
    """A tensor on neither the CPU nor a card is refused, never silently
    moved (the meta device stands in for one)."""
    x = torch.empty((4, 8), device="meta")
    calls = {
        "linear": lambda: kul.unified_linear(x, torch.empty((8, 2),
                                                            device="meta")),
        "lut": lambda: kgl.lut_activation(x),
        "attention": lambda: kfa.flash_attention(x[None, None], x[None, None],
                                                 x[None, None]),
        "moe": lambda: kmg.moe_gemm(x[None], torch.empty((1, 8, 2),
                                                         device="meta"),
                                    torch.empty((1,), dtype=torch.int32,
                                                device="meta")),
    }
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        calls[name]()
