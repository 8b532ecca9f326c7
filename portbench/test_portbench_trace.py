"""The profile reader and the per-layer readers on a synthetic profile."""

import pytest

from portbench import devtrace, run, work
from portbench.devtrace import Event


def _profile():
    """Two steps: an oracle kernel, a rule kernel and one gossip window of
    two kernels each, launched from the ranges the program and the harness
    open; the device idles 10 µs at the start of each step."""
    evs = [Event(devtrace.WINDOW, "user_annotation", 0, 300, 1, 0, 7)]
    corr = 100
    for s, base in enumerate((0, 150)):
        evs.append(Event(devtrace.STEP, "user_annotation", base, base + 140,
                         2 + s, 0, 7))
        evs.append(Event("obs_grad", "user_annotation", base + 1, base + 5,
                         10 + s, 0, 7))
        evs.append(Event("obs_mix", "user_annotation", base + 6, base + 9,
                         20 + s, 0, 7))
        evs.append(Event("aten::mm", "cpu_op", base + 2, base + 4, 30 + s, 0,
                         7))
        launches = [(base + 3, "ampere_sgemm", base + 10, base + 70),
                    (base + 7, "gossip_mix_collapse_kernel", base + 70,
                     base + 72),
                    (base + 8, "gossip_mix_warp_kernel", base + 72,
                     base + 90),
                    (base + 12, "elementwise_kernel", base + 90, base + 100)]
        for ts, name, a, b in launches:
            corr += 1
            evs.append(Event("cudaLaunchKernel", "cuda_runtime", ts, ts + 0.5,
                             corr, 30 + s, 7))
            evs.append(Event(name, "kernel", a, b, corr, 30 + s, 0))
    evs.append(Event("cudaDeviceSynchronize", "cuda_runtime", 280, 300, 999,
                     0, 7))
    return evs


def test_summary_splits_device_time_by_launching_range():
    t = devtrace.summarize(_profile())
    assert t["steps"] == 2 and t["kernels"] == 8 and t["unmatched"] == 0
    assert t["grad_ms"] == pytest.approx(2 * 60e-3)
    assert t["mix_ms"] == pytest.approx(2 * 20e-3)
    assert t["rule_ms"] == pytest.approx(2 * 10e-3)
    assert t["window_s"] == pytest.approx(300e-6)
    assert t["busy_s"] == pytest.approx(180e-6)
    assert len(t["mix_windows"]) == 2
    idle = dict(t["idle_by_host"])
    assert sum(idle.values()) == pytest.approx(120e-6)
    assert idle["cudaDeviceSynchronize"] == pytest.approx(20e-6)
    assert t["device_by_name"][0][0] == "ampere_sgemm"


def test_readers_on_the_summary():
    cell = run.load_cell("qwen1.5-0.5b.train4k")
    from portbench.kinds import decentralized_train as dt
    from portbench.reference import decoder

    summary = devtrace.summarize(_profile())

    class Ctx:
        trace = summary
        info = dt.cell_info(decoder, cell["config"], cell["traffic"],
                            463_987_712)

    Ctx.cell = Ctx.info
    read = {m["name"]: run._reader(m["name"]).read(Ctx)
            for m in cell["per_layer"]}
    assert read["kernels_per_step"] == 4
    assert read["oracle_ms"] == pytest.approx(60e-3)
    assert read["mix_ms"] == pytest.approx(20e-3)
    assert read["rule_ms"] == pytest.approx(10e-3)
    assert read["idle_pct"] == pytest.approx(40.0)
    least = work.least_seconds(work.gossip_mix(4, 463_987_712, 2, 4))
    assert read["gossip_mix_roofline"] == pytest.approx(
        100 * least / 20e-6)
    flops = 4 * 2 * decoder.model_flops(cell["config"], 1, 4096)
    # the profiled steps over the traced window, both from the trace
    assert read["step_mfu"] == pytest.approx(100 * flops * 2 / 300e-6 / 67e12)
    Ctx.trace = dict(summary, steps=3, window_s=15.0)
    mfu = run._reader("step_mfu").read(Ctx)
    assert mfu == pytest.approx(100 * flops * 3 / 15 / 67e12)
    assert 30 < mfu < 45


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_precision_comes_from_the_configuration(dtype):
    """The peak step_mfu is held against and the state's bytes follow the
    configuration's stated precision; the run refuses what the plain
    reference does not compute."""
    from portbench.kinds import decentralized_train as dt
    from portbench.reference import decoder
    from portbench.tinycells import TINY_DECODER, TINY_TRAIN

    config = dict(TINY_DECODER, training_dtype=dtype)
    info = dt.cell_info(decoder, config, TINY_TRAIN, 1024)
    assert info["precision"] == dtype
    assert info["x_bytes"] == info["res_bytes"] == (2 if dtype == "bfloat16"
                                                    else 4)
    if dtype != "float32":
        with pytest.raises(ValueError):
            dt.run(decoder, config, TINY_TRAIN, {}, seed=1, seconds=0.1,
                   trace=False, device="cpu", t_start=0.0)


def test_a_profile_without_ranges_is_refused():
    with pytest.raises(ValueError):
        devtrace.summarize([Event("k", "kernel", 0, 1, 1, 0, 0)])
