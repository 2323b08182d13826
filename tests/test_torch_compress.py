"""Int8 gradient compression with error feedback (``dist/compress.py``)
against the reference's ``repro.dist.compress`` on the same NumPy
inputs: the quantizer bit for bit (a ragged last chunk, an all-zero
chunk, values at exact half steps, where both round half to even),
``compressed_bytes``, ``compressed_psum`` at a mesh of one against the
reference's ``shard_map`` on ``jax.make_mesh((1,))``, its non-finite
values dropped (``tests/test_dist_compress_edges.py``), EF convergence on
the reference's quadratic, and the stacked mean.  Over two ranks the sum
and the mean are held in ``tests/test_torch_dist_train.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.dist import compress as JC
from repro_torch.dist import compress as C
from test_torch_threads import one_torch_thread  # noqa: F401


def _cases():
    rng = np.random.default_rng(0)
    ragged = (rng.standard_normal(700) * 3).astype(np.float32)
    zero_chunk = rng.standard_normal(3 * C.CHUNK).astype(np.float32)
    zero_chunk[C.CHUNK:2 * C.CHUNK] = 0.0
    # a chunk whose amax is 127: the scale is 1, and k + 0.5 lies exactly
    # half way between two steps
    half = np.concatenate([[127.0], np.arange(-60, 60) + 0.5,
                           np.full(C.CHUNK - 121, -2.5)]).astype(np.float32)
    matrix = rng.standard_normal((5, 3, 33)).astype(np.float32)
    return {"ragged": ragged, "zero_chunk": zero_chunk, "half": half,
            "matrix": matrix}


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_quantizer_is_the_reference_bit_for_bit(name):
    x = CASES[name]
    jq, js = JC.quantize_int8(jnp.asarray(x))
    q, s = C.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    got = C.dequantize_int8(q, s, x.shape)
    want = JC.dequantize_int8(jq, js, x.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert C.compressed_bytes(torch.from_numpy(x)) == \
        JC.compressed_bytes(jnp.asarray(x))


def test_half_steps_round_to_even():
    q, s = C.quantize_int8(torch.from_numpy(CASES["half"]))
    assert float(s[0, 0]) == 1.0
    vals = q[0, 1:121].tolist()
    want = np.round(np.arange(-60, 60) + 0.5).astype(int).tolist()
    assert vals == want and q[0, 121] == -2      # -2.5 -> -2


def test_all_zero_chunk_keeps_scale_zero():
    q, s = C.quantize_int8(torch.from_numpy(CASES["zero_chunk"]))
    assert float(s[1, 0]) == 0.0 and not q[1].any()
    out = C.dequantize_int8(q, s, CASES["zero_chunk"].shape)
    assert not out[C.CHUNK:2 * C.CHUNK].any()


@functools.lru_cache(maxsize=None)
def _jpsum():
    mesh = jax.make_mesh((1,), ("data",))
    return jax.shard_map(lambda g, e: JC.compressed_psum(g, e,
                                                         axes=("data",)),
                         mesh=mesh, in_specs=(JP(), JP()),
                         out_specs=(JP(), JP()), check_vma=False)


def test_compressed_psum_at_a_mesh_of_one_is_the_reference():
    """Two steps with the carry fed back: the output is the dequantized
    payload and the carry ``gf - deq``, bit for bit the reference's."""
    from _torch_mesh import mesh_of_one

    rng = np.random.default_rng(1)
    gs = [{"a": rng.standard_normal((40, 9)).astype(np.float32),
           "b": {"c": rng.standard_normal(513).astype(np.float32)}}
          for _ in range(2)]
    jerr = JC.init_error_state(jax.tree.map(jnp.asarray, gs[0]))
    err = C.init_error_state({"a": torch.from_numpy(gs[0]["a"]),
                              "b": {"c": torch.from_numpy(gs[0]["b"]["c"])}})
    for g in gs:
        jout, jerr = _jpsum()(jax.tree.map(jnp.asarray, g), jerr)
        tg = {"a": torch.from_numpy(g["a"]),
              "b": {"c": torch.from_numpy(g["b"]["c"])}}
        out, err = C.compressed_psum(tg, err, mesh_of_one(), axes=("data",))
        for get in (lambda t: t["a"], lambda t: t["b"]["c"]):
            np.testing.assert_array_equal(get(out).numpy(),
                                          np.asarray(get(jout)))
            np.testing.assert_array_equal(get(err).numpy(),
                                          np.asarray(get(jerr)))


def test_nonfinite_grad_does_not_poison_error_state():
    """The reference's edge case: inf and NaN dropped, the carry finite,
    and the next healthy step recovers (atol 0.05), as the reference's."""
    from _torch_mesh import mesh_of_one

    bad = np.asarray([np.inf, 1.0, np.nan, -2.0], np.float32)
    ok = np.asarray([0.5, 1.0, -1.0, -2.0], np.float32)
    err = C.init_error_state({"w": torch.from_numpy(bad)})
    jerr = JC.init_error_state({"w": jnp.asarray(bad)})
    for g in (bad, ok):
        out, err = C.compressed_psum({"w": torch.from_numpy(g)}, err,
                                     mesh_of_one())
        jout, jerr = _jpsum()({"w": jnp.asarray(g)}, jerr)
        assert torch.isfinite(out["w"]).all() and torch.isfinite(
            err["w"]).all()
        np.testing.assert_array_equal(out["w"].numpy(),
                                      np.asarray(jout["w"]))
        np.testing.assert_array_equal(err["w"].numpy(),
                                      np.asarray(jerr["w"]))
    np.testing.assert_allclose(out["w"].numpy(), ok, atol=0.05)


def test_ef_converges_like_uncompressed():
    """The reference's quadratic: SGD with compressed gradients and the EF
    carry reaches its bounds, and every iterate is the reference's bit for
    bit."""
    rng = np.random.default_rng(2)
    target = rng.standard_normal((64, 64)).astype(np.float32)
    t_target, j_target = torch.from_numpy(target), jnp.asarray(target)

    def run(compressed):
        w, err = torch.zeros(64, 64), torch.zeros(64, 64)
        jw, jerr = jnp.zeros((64, 64)), jnp.zeros((64, 64))
        for i in range(300):
            g = 2 * (w - t_target) / target.size
            jg = 2 * (jw - j_target) / target.size
            if compressed:
                gf, jgf = g + err, jg + jerr
                q, s = C.quantize_int8(gf)
                jq, js = JC.quantize_int8(jgf)
                deq = C.dequantize_int8(q, s, gf.shape)
                jdeq = JC.dequantize_int8(jq, js, jgf.shape)
                err, jerr = gf - deq, jgf - jdeq
                g, jg = deq, jdeq
                if i in (0, 299):
                    np.testing.assert_array_equal(deq.numpy(),
                                                  np.asarray(jdeq))
            w, jw = w - 20.0 * g, jw - 20.0 * jg
        return float(torch.mean((w - t_target) ** 2))

    plain, comp = run(False), run(True)
    assert comp < 0.01 and comp < max(plain * 100, 0.01)


def test_stacked_mean_at_a_mesh_of_one():
    """Each rank's row is the shard mean (one shard: the dequantized row),
    the carry per shard; the reference's on ``jax.make_mesh((1,))``."""
    from _torch_mesh import mesh_of_one

    g = np.random.default_rng(3).standard_normal((1, 512)).astype(
        np.float32)
    mesh = jax.make_mesh((1,), ("data",))
    jout, jerr = JC.compressed_allreduce_stacked(
        {"w": jnp.asarray(g)}, {"w": jnp.zeros((1, 512), jnp.float32)},
        mesh)
    out, err = C.compressed_allreduce_stacked(
        {"w": torch.from_numpy(g)}, {"w": torch.zeros(1, 512)},
        mesh_of_one())
    assert out["w"].shape == (1, 512)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))
    np.testing.assert_array_equal(err["w"].numpy(), np.asarray(jerr["w"]))
    assert float((out["w"] - torch.from_numpy(g)).abs().max()) < 0.05
