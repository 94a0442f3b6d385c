"""The readers of the port's spans (harness/spans.py and the metrics of
source `program_span`): on the CPU, on hand-built profile passes; on the
card (`-m cuda`), on every cell's own traced run."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import cell as cells, spans
from portbench.harness.profile import Profile

ROOT = Path(__file__).resolve().parents[2]
SPAN_METRICS = ("forward_ms.train", "backward_ms.train", "preprocess_ms.train",
                "host_dispatch_ms.train", "syncs_per_step.train", "preprocess_ms.serve",
                "h2d_ms.serve")


def _profile(host_ops, kernels=(), copies=(), units=1):
    """A profile pass of `units` units: host_ops (name, start, end); kernels
    (name, start, dur); copies (start, end); times in us."""
    busy = sum(d for _, _, d in kernels) + sum(e - s for s, e in copies)
    return Profile(units, 1.0, busy / 1e6, list(kernels), list(copies), list(host_ops))


def _step(t0=0.0, mirror=False):
    """One train step [t0, t0 + 100): forward [10, 40) launching at 20 and
    30, backward [50, 90) whose two launches come from autograd's thread
    (host events listed after the span's own), a launch at 95 in the step
    alone; an upload copy in forward; the kernels run 5 us after their
    calls. `mirror` adds the device mirror a user-scope range would get."""
    host = [("avt.train.step", t0, t0 + 100), ("avt.train.forward", t0 + 10, t0 + 40),
            ("cudaLaunchKernel", t0 + 20, t0 + 22), ("cudaMemcpyAsync", t0 + 25, t0 + 26),
            ("cudaLaunchKernel", t0 + 30, t0 + 32), ("avt.train.backward", t0 + 50, t0 + 90),
            ("cudaLaunchKernel", t0 + 95, t0 + 96),
            ("autograd::engine::evaluate_function: MmBackward0", t0 + 55, t0 + 80),
            ("cudaLaunchKernel", t0 + 60, t0 + 62), ("cuLaunchKernelEx", t0 + 70, t0 + 72)]
    kernels = [("fwd_a", t0 + 25, 3.0), ("fwd_b", t0 + 35, 4.0), ("bwd_a", t0 + 65, 7.0),
               ("bwd_b", t0 + 75, 11.0), ("tail", t0 + 100, 2.0)]
    if mirror:
        kernels.append(("avt.train.forward", t0 + 25, 14.0))
    return host, kernels, [(t0 + 30, t0 + 31)]


@pytest.mark.parametrize("mirror", [False, True], ids=["plain", "with-device-mirror"])
def test_launches_go_to_their_innermost_span(mirror):
    host, kernels, copies = _step(mirror=mirror)
    s = spans.read(_profile(host, kernels, copies))
    assert s.counts == {"kernel": (5, 5), "copy": (1, 1)}
    assert s.device_s("avt.train.forward") == pytest.approx(8e-6)  # 3 + 4 + the copy's 1
    assert s.device_s("avt.train.backward") == pytest.approx(18e-6)  # from autograd's thread
    assert s.device_s("avt.train.step") == pytest.approx(28e-6)  # children included
    assert [s.names[i] for i in s.innermost()] == [
        "avt.train.forward", "avt.train.forward", "avt.train.backward", "avt.train.backward",
        "avt.train.step", "avt.train.forward"]
    assert s.outside_s() == 0.0
    assert (s.act_start >= s.call_start).all()


def test_launch_outside_every_span_and_counts_that_differ():
    host, kernels, copies = _step()
    host.append(("cudaLaunchKernel", 200, 201))
    kernels.append(("after", 205, 6.0))
    s = spans.read(_profile(host, kernels, copies))
    assert s.outside_s() == pytest.approx(6e-6)
    # a kernel whose call the trace lost takes none (no call began before it
    # that an earlier kernel did not take); the others keep their own
    lost = spans.read(_profile(host, kernels + [("lost", 150, 9.0)], copies))
    assert lost.counts["kernel"] == (6, 7)
    assert lost.device_s("avt.train.backward") == pytest.approx(18e-6)
    assert lost.outside_s() == pytest.approx(15e-6)


def test_synchronising_calls_and_host_dispatch():
    host, kernels, copies = _step()
    host += [("cudaStreamSynchronize", 41, 47), ("cudaMemcpy", 44, 49),  # union 41-49: 8
             ("cudaMemcpyAsync", 91, 92),  # queues, does not block
             ("cudaEventSynchronize", 98, 104)]  # clipped at the step's end: 2
    two = [(n, s + o, e + o) for o in (0.0, 1000.0) for n, s, e in host]
    run = cells.Run(cell=None, window={}, profile=_profile(two, units=2))
    assert spans.syncs_per_unit(run, "avt.train.step") == 3.0
    assert spans.unsynced_ms(run, "avt.train.step") == pytest.approx((100 - 10) / 1e3)
    assert spans.host_ms(run, "avt.train.backward") == pytest.approx(40 / 1e3)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_program_without_the_spans_reads_nothing(metric):
    """The parent commit's program opens no avt. range: every reader
    returns None (the metric is left out), and so without a profile pass."""
    host, kernels, copies = _step()
    bare = [(n, s, e) for n, s, e in host if not n.startswith("avt.")]
    read = cells.reader(metric)
    assert read(cells.Run(cell=None, window={}, profile=_profile(bare, kernels, copies))) is None
    assert read(cells.Run(cell=None, window={}, profile=None)) is None


CELLS = ["avt_b_h_ek100.train_b24", "avt_h_tsn_ek100.train_t256", "avt_b_h_ek100.serve_req8",
         "avt_h_tsn_ek100.train_t10"]
SEED = 2 ** 31 + 211


def _trace_links(p, s) -> dict:
    """What the torch profiler `p`'s own ids say, against `s` (its pass as
    harness/spans.py reads it): the kernels whose order pairing differs
    from the trace's correlation ids; the least launch-to-start lead by
    those ids (us); the kernels launched on the spans' thread whose span
    by launch time differs from the span holding the CPU event the kernel
    is linked to (on the host events' clock alone); and the device ms a
    unit of the kernels other threads launched, by span at launch time."""
    res = p.profiler.kineto_results
    t0 = res.trace_start_ns()
    calls, kernels, ops, ranges = {}, [], {}, {}
    for e in res.events():
        n, start = e.name(), (e.start_ns() - t0) / 1e3
        if str(e.device_type()).endswith("CUDA"):
            if not n.startswith(("Memcpy", "Memset", "memcpy", "memset", spans.PREFIX,
                                 "portbench.")):
                kernels.append((start, e.duration_ns() / 1e3, e.correlation_id(),
                                e.linked_correlation_id()))
        elif n in spans.KERNEL_CALLS:
            calls[e.correlation_id()] = start
        else:
            ops[e.correlation_id()] = (start, e.start_thread_id())
            if n.startswith(spans.PREFIX):
                ranges.setdefault(e.start_thread_id(), []).append(
                    (n, start, start + e.duration_ns() / 1e3))
    kernels.sort()
    nk = s.counts["kernel"][1]
    if len(kernels) != nk:
        return {"mismatched": nk, "clock_mismatched": None, "other_threads_ms": None,
                "lead_us_min": None}
    true_call = np.array([calls.get(c, np.nan) for _, _, c, _ in kernels])
    inner = s.innermost()[:nk]
    clock_mismatched, other = 0, {}
    for i, (_, d, _, linked) in enumerate(kernels):
        by_time = s.names[inner[i]] if inner[i] >= 0 else None
        start, tid = ops.get(linked, (np.nan, None))
        if tid not in ranges:
            other[str(by_time)] = other.get(str(by_time), 0.0) + d / 1e3 / s.units
            continue
        held = [(e - b, n) for n, b, e in ranges[tid] if b <= start <= e]
        clock_mismatched += by_time != (min(held)[1] if held else None)
    lead = np.array([k[0] for k in kernels]) - true_call
    return {"mismatched": int((~np.isclose(s.call_start[:nk], true_call)).sum()),
            "clock_mismatched": clock_mismatched, "other_threads_ms": other,
            "lead_us_min": float(np.nanmin(lead)) if nk else None}


def _card_reading(cell_name: str, spans_on: bool) -> dict:
    """One traced run of the cell on the card (with `trace.span` patched to
    its no-op unless `spans_on`) and what the card test checks in it."""
    import torch.profiler as tp

    from avt_tpu_torch.utils import trace

    kept = []

    class Kept(tp.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            kept.append(self)
            return out

    tp.profile = Kept
    if not spans_on:
        trace.span = lambda name: trace.OFF
    cell = cells.load_cell(cell_name)
    r = cells.run(cell, SEED, 2.0, True, "cuda")
    prof, s = r["profile"], spans.read(r["profile"])
    out = {"correct": r["correct"], "metrics": {k: v["value"] for k, v in r["metrics"].items()},
           "avt_device_ops": [n for n, _, _ in prof.kernels if n.startswith(spans.PREFIX)],
           "wanted": [m["name"] for m in cell.per_layer if m["name"] in SPAN_METRICS],
           "spans": s is not None}
    if s is None:
        return out
    links = _trace_links(kept[-1], s)
    out.update(links, counts=s.counts,
               outside_share=s.outside_s() / (float(s.act_dur.sum()) / 1e6),
               syncs_a_unit={n: sum(map(len, s.syncs_in(n))) / s.units for n in set(s.names)})
    if cell.driver.MODE == "train":
        phases = [p for p in ("avt.train.forward", "avt.train.backward", "avt.train.optimizer",
                              "avt.preprocess.train") if s.has(p)]
        out["phase_share"] = (sum(s.device_s(p) for p in phases)
                              / s.device_s("avt.train.step"))
    return out


def _on_the_card(cell_name: str, spans_on: bool) -> dict:
    """`_card_reading` in a process of its own, as the benchmark runs a
    cell: one profile pass a process (a second pass in one process loses
    a kernel's record now and then, and its clock may slip)."""
    code = ("import json, sys; from portbench.tests.test_portbench_spans import _card_reading; "
            f"print(json.dumps(_card_reading({cell_name!r}, {spans_on!r})))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_spans_on_the_card(cell_name):
    """A traced run of the cell: calls and activities pair up one to one,
    as the trace's correlation ids pair them; every kernel launched on the
    spans' thread is given the span its linked CPU event ran in, so the
    spans' and the launch calls' clocks agree; the launches outside every
    avt. span are under 2% of a unit's kernel time; a train step's phases
    hold 95% of its kernel time; no avt. name among the device's
    activities; each span metric of the cell reads; and
    launches_per_step.train reads the same with `trace.span` patched to its
    no-op. The device clock is not checked: CUPTI's kernel times slipped up
    to 3 ms before their launch calls in some runs on an H100, the pairing exact all
    the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans are read from the card's trace")
    on = _on_the_card(cell_name, True)
    print(f"spans {cell_name}: {on}")
    if "phase_share" in on:
        off = _on_the_card(cell_name, False)
        print(f"spans off {cell_name}: {off}")
        assert not off["spans"]
        assert off["metrics"]["launches_per_step.train"] == on["metrics"][
            "launches_per_step.train"]
        assert on["phase_share"] >= 0.95
    assert on["correct"] and on["avt_device_ops"] == []
    assert on["wanted"] and all(n in on["metrics"] for n in on["wanted"])
    assert all(calls == acts for calls, acts in on["counts"].values())
    assert on["mismatched"] == 0 and on["clock_mismatched"] == 0
    assert on["outside_share"] < 0.02
