"""The generator: seeded traffic identical across runs, every seed the
same mix of sizes, and the frozen work counts against the configurations'
sizes."""

import json
from collections import Counter

import pytest
import torch

from ebench import manifest as M
from ebench import traffic as T
from ebench import weights, work

MANIFEST = M.load()
LM_CELLS = [w for w in MANIFEST["workloads"]
            if M.config(MANIFEST, w)["driver"] == "lm"]


def _cfg(name):
    return json.loads((M.ROOT / f"edgebench/configs/{name}.json").read_text())


@pytest.mark.parametrize("cell", LM_CELLS, ids=lambda w: w["name"])
def test_closed_lm_traffic_repeats_and_keeps_its_mix(cell):
    tr = M.traffic(MANIFEST, cell)
    a, b = T.ClosedLM(tr, 2**31 + 5, 1000), T.ClosedLM(tr, 2**31 + 5, 1000)
    other = T.ClosedLM(tr, 7, 1000)
    n = tr["clients"]
    for k in range(4):
        shapes = [a.shape(c, k) for c in range(n)]
        assert shapes == [b.shape(c, k) for c in range(n)]
        # one block: the same multiset of lengths under every seed
        assert Counter(shapes[i][0] for i in range(n)) \
            == Counter(other.shape(c, k)[0] for c in range(n))
        assert Counter(s[1] for s in shapes) \
            == Counter(other.shape(c, k)[1] for c in range(n))
    # in an order of the seed's
    assert [a.shape(c, k) for k in range(4) for c in range(n)] \
        != [other.shape(c, k) for k in range(4) for c in range(n)]
    assert (a.tokens(3, 2, 50) == b.tokens(3, 2, 50)).all()
    assert not (a.tokens(3, 2, 50) == other.tokens(3, 2, 50)).all()
    lo, hi = tr["prompt"]["min"], tr["prompt"]["max"]
    assert lo <= a.shortest_prompt() <= a.longest_prompt() <= hi
    cfg = M.config(MANIFEST, cell)
    assert hi + tr["output"]["max"] <= cfg["serve"]["max_len"]


def test_lognormal_quantiles_median_and_clip():
    spec = {"median": 512, "sigma": 0.8, "min": 64, "max": 2048}
    q = T.lognormal_quantiles(spec, 33)
    assert q == sorted(q) and q[16] == 512
    assert min(q) >= 64 and max(q) <= 2048


def test_open_arrivals_repeat_and_follow_the_bursts():
    tr = {"rate_per_s": 400.0, "cameras": 16,
          "burst": {"period_s": 2.0, "on_s": 1.0, "on_factor": 1.5,
                    "off_factor": 0.5}}
    a = T.open_arrivals(tr, 99, 20.0)
    assert a == T.open_arrivals(tr, 99, 20.0)
    assert a != T.open_arrivals(tr, 98, 20.0)
    on = sum(1 for t, _ in a if t % 2.0 < 1.0)
    assert 2.4 < on / (len(a) - on) < 3.6      # 1.5 / 0.5 = 3
    assert abs(len(a) / 20.0 - 400.0) < 40.0
    assert all(0 <= c < 16 for _, c in a)


def test_image_index_is_a_function_of_seed_client_and_frame():
    assert T.image_index(5, 256, 3, 7) == T.image_index(5, 256, 3, 7)
    idx = {T.image_index(5, 256, c, k) for c in range(16) for k in range(16)}
    assert len(idx) > 100


def test_weights_repeat_and_match_the_port_names():
    from dataclasses import replace

    from repro_torch.configs import get
    from repro_torch.models import model, vit

    v = dict(_cfg("m3vit"), name="m3vit")
    port = vit.param_specs(get("m3vit"))
    mine = {n: (s, d) for n, s, d, _ in weights.specs(v)}
    assert mine == {n: (tuple(t.shape), t.dtype) for n, t in port.items()}
    lm = dict(_cfg("deepseek_67b"), name="deepseek_67b")
    port = model.param_specs(replace(get("deepseek_67b"), num_layers=16))
    mine = {n: (s, d) for n, s, d, _ in weights.specs(lm)}
    assert mine == {n: (tuple(t.shape), t.dtype) for n, t in port.items()}
    tiny = dict(v, num_layers=2, d_model=32, d_ff=64, expert_d_ff=32)
    a = weights.draw(tiny, 2**33 + 1, "cpu")
    b = weights.draw(tiny, 2**33 + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_frozen_counts_against_the_sizes():
    lm = _cfg("deepseek_67b")
    d, f, v, n = 8192, 22016, 102400, 16
    per_layer = d * d + 2 * d * 1024 + d * d + 3 * d * f
    assert work.lm_linear_params(lm) == per_layer
    from dataclasses import replace

    from repro_torch.configs import get

    port = replace(get("deepseek_67b"), num_layers=16)
    assert n * per_layer + 2 * d * v == port.param_count()
    # one decode lane at cache length 1: every product's weights once
    assert work.lm_decode_flops(lm, [1]) == pytest.approx(
        2.0 * (port.param_count() - d * v) + 4.0 * 64 * 128 * n)
    bounds = {}
    work.lm_decode_kernels(lm, [1] * 32, bounds, (989e12, 3.35e12))
    weight_bytes = 2.0 * (n * per_layer + d * v)
    assert bounds["unified_linear"].bytes == pytest.approx(
        weight_bytes, rel=0.01)
    vit = _cfg("m3vit")
    t, dm = 128, 192
    frame = work.vit_frame_flops(vit, 1)
    want = (2 * t * 768 * dm + 12 * (8 * t * dm * dm + 4 * t * t * dm)
            + 6 * 4 * t * dm * 768 + 6 * (2 * t * dm * 16
                                          + 4 * t * 4 * dm * 768)
            + 2 * t * dm * 256)
    assert frame == want
    assert work.vit_frame_flops(vit, 0) - frame == 2 * t * dm * 256 * 18


def test_sweep_calls_a_rate_sustained_only_without_a_backlog():
    import sweep

    ok = {"due": 1000, "done": 990.0, "backlog": 10, "p95_ms": 300.0}
    assert sweep.sustained(ok, 256)
    assert not sweep.sustained(dict(ok, done=900.0), 256)
    assert not sweep.sustained(dict(ok, backlog=600), 256)
    assert not sweep.sustained(dict(ok, p95_ms=1500.0), 256)


def test_trace_reduction_busy_idle_and_gaps():
    from ebench.tracing import reduce

    device = [(10.0, 20.0, "void unified_linear_tc_kernel<2, 1>(P)"),
              (15.0, 30.0, "Memcpy DtoH (Device -> Pinned)"),
              (50.0, 60.0, "decode_fused_kernel")]
    spans = {"step": [(0.0, 100.0)], "decode": [(40.0, 70.0)]}
    out = reduce(device, spans, (0.0, 100.0), 100e-6)
    assert out["busy_s"] == pytest.approx(30e-6)     # [10, 30] and [50, 60]
    assert out["kernel_s"]["unified_linear_tc_kernel"] == pytest.approx(10e-6)
    gaps = dict(out["idle_gaps"])
    # idle [0, 10] and [60, 100] inside the step alone, [30, 50] (its
    # middle, 40) inside the decode call
    assert gaps == pytest.approx({"scheduler": 50e-6, "decode": 20e-6})


@pytest.mark.parametrize("path", sorted((M.ROOT / "edgebench" / "traffic")
                                        .glob("*.json")), ids=lambda p: p.stem)
def test_every_mix_names_its_public_source(path):
    tr = json.loads(path.read_text())
    assert tr["loop"] in ("closed", "open")
    assert tr["source"].strip() and tr["why"].strip()
    assert isinstance(tr.get("assumed", {}), dict)
