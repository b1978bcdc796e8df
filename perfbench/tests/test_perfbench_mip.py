"""The mipnerf-train-blender cell on the CPU at tiny sizes (16 rays a step
at the published widths and samples, 32x32 views): a correct run and a
traced one, each fault and the control fail, and the readers of its
per-layer metrics against hand counts on synthetic traces."""

import argparse

import pytest
import torch

from perfbench import calibrate, calibrate_mip, program_spans, roofline_mip, run
from perfbench.trace import Trace

BENCH = run.load_json(run.ROOT / "BENCHMARK.json")
CELL = "mipnerf-train-blender"
CPU = torch.device("cpu")
TINY = {"config": {"flags": ["--mipnerf", "--num_rays", "16"], "num_rays": 16},
        "traffic": {"views": 4, "hw": 32, "scene_samples": 16, "warm_steps": 4,
                    "trace_after": 1, "trace_steps": 2, "loss_read_interval": 2}}
CONFIG = run.load_json(run.HERE / "configs" / "mipnerf-blender.json")


def _args(trace=0):
    return run.parse(["--workload", CELL, "--seed", "2147483999", "--seconds", "1",
                      "--trace", str(trace)])


def test_a_run_is_correct_and_reports_its_metrics():
    res, checks, _ = run.execute(_args(), device=CPU, bench=BENCH, overrides=TINY)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_rays_per_s.dense", "setup_s"}
    assert {c.name for c in checks} == {"loss", "grad", "change", "resample"}


def test_a_traced_run_reports_the_span_and_counter_metrics():
    before = program_spans.counters() or {}
    res, _, _ = run.execute(_args(trace=1), device=CPU, bench=BENCH, overrides=TINY)
    assert res["correct"]
    # on the CPU only the program's counters read; the device metrics need kernels
    assert set(res["metrics"]) == {"mip.host_syncs_per_step"}
    assert res["metrics"]["mip.host_syncs_per_step"]["value"] == 0.0
    after = program_spans.counters()
    traced = 2 * 16 * CONFIG["num_samples"] * TINY["traffic"]["trace_steps"] // 2
    for level in ("render.coarse", "render.fine"):
        got = after[level]["mlp_samples"] - before.get(level, {}).get("mlp_samples", 0)
        assert got == traced


@pytest.mark.parametrize("fault", sorted(calibrate_mip.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault):
    undo = calibrate_mip.FAULTS[fault]()
    try:
        res, _, _ = run.execute(_args(), device=CPU, bench=BENCH, overrides=TINY)
    finally:
        undo()
    assert not res["correct"], res["checks"]


def test_the_control_is_not_correct():
    readings = calibrate.one(argparse.Namespace(workload=CELL, seconds=1.0), 2147483001, CPU,
                             BENCH, "control", TINY)
    limits = BENCH and run.cell_spec(BENCH, CELL)[2]["limits"]
    assert any(readings[k] > limits[k] for k in readings), readings


# ----------------------------------------------------------- the readers
KERNELS = [("nvjet_tss_128x256_64x4_2x1_v_badd_coopA_NNN", 0, 4_000),
           ("void cutlass::Kernel2<cutlass_80_tensorop_s16816gemm_bf16_256x128_64x3_nt_align8>"
            "(cutlass_80_tensorop_s16816gemm_bf16_256x128_64x3_nt_align8::Params)", 5_000, 7_000),
           ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", 8_000, 9_000),
           ("void cublasLt::splitKreduce_kernel<32, 16, int, float, float>", 9_000, 9_500),
           ("void gemv2T_kernel_val<int, int, float, 128, 16, 4, 4, false>", 10_000, 10_500),
           ("void at::native::vectorized_elementwise_kernel<4, at::native::exp_kernel_cuda>",
            11_000, 20_000),
           ("Memcpy HtoD (Pageable -> Device)", 20_000, 30_000)]


def test_the_gemm_names_and_launches():
    tr = Trace(window_s=40e-6, kernels=list(KERNELS))
    assert [roofline_mip.is_gemm(n) for n, _, _ in KERNELS] == [True] * 5 + [False] * 2
    assert roofline_mip.gemm_launches(tr) == 4          # the split-K reduce is no matmul
    assert roofline_mip.gemm_seconds(tr) == pytest.approx(8e-6)     # 4 + 2 + 1 + 0.5 + 0.5 us


def test_operations_by_hand_at_the_published_widths():
    assert roofline_mip.forward_flops(1, CONFIG) == 1_220_608
    # backward: weight gradients of all twelve layers, input gradients of
    # all but the first trunk layer (96 x 256 products)
    assert roofline_mip.train_flops(1, CONFIG) == 3 * 1_220_608 - 2 * 96 * 256
    assert roofline_mip.matmuls_per_level(CONFIG) == 34
    n = 2 * 4096 * 128
    assert roofline_mip.train_bound_s(n, CONFIG) == pytest.approx(
        roofline_mip.train_flops(n, CONFIG) / 989e12)      # operations bound it


def test_readers_on_a_synthetic_trace(monkeypatch):
    tr = Trace(window_s=40e-6, kernels=list(KERNELS))
    tr.counters = {"steps": 2}
    samples = 1000
    monkeypatch.setattr(program_spans, "counters", lambda: {
        "render.coarse": {"calls": 2, "mlp_samples": samples // 2, "host_syncs": 1},
        "render.fine": {"calls": 2, "mlp_samples": samples // 2, "host_syncs": 0},
        "train.step": {"calls": 2, "host_syncs": 3}})
    ctx = run.Ctx(name=CELL, config=CONFIG, traffic={}, seed=0, device=None, spans=None,
                  trace=True)

    def read(name):
        return run.load_module(run.reader_path(name), name.replace(".", "_")).read(tr, ctx)

    assert read("mip.mfu") == pytest.approx(100 * 3 * 1_220_608 * samples / 40e-6 / 989e12)
    assert read("mip.mlp_roofline") == pytest.approx(
        100 * roofline_mip.train_bound_s(samples, CONFIG) / 8e-6)
    assert read("mip.host_syncs_per_step") == 2.0
    monkeypatch.setattr(program_spans, "counters", lambda: None)
    assert read("mip.mfu") is None and read("mip.mlp_roofline") is None



@pytest.mark.card
def test_on_the_card_the_matched_gemms_are_the_mlps_matmuls(monkeypatch):
    """A traced tiny run on the card: the kernels the roofline reader takes
    for GEMMs launch exactly the MLP's matmuls a step, and the shares read
    above 0 and at most 100%. Skips without a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the run needs one")
    from contextlib import contextmanager

    import perfbench.trace as ptrace

    traces, traced0 = [], ptrace.traced

    @contextmanager
    def keeping(*a, **k):
        with traced0(*a, **k) as tr:
            traces.append(tr)
            yield tr

    monkeypatch.setattr(ptrace, "traced", keeping)
    res, _, _ = run.execute(_args(trace=1), device=torch.device("cuda", 0), bench=BENCH,
                            overrides=TINY)
    assert res["correct"], res["checks"]
    (tr,) = traces
    per_step = 2 * roofline_mip.matmuls_per_level(CONFIG)
    assert roofline_mip.gemm_launches(tr) == tr.counters["steps"] * per_step
    for name in ("mip.mfu", "mip.mlp_roofline"):
        assert 0 < res["metrics"][name]["value"] <= 100
