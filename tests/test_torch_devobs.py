"""Device observability of the port against the JAX package's, on the CPU:
the compile sentinel, the step ledger's compile events, the device-memory
ledger and budget, the dequantization audit, and the card's bring-up.

- ``CompileWatcher`` fed the same ``record`` calls and knobs as JAX's gives
  equal ``state()``, events and metrics, timestamps aside; ``_shape_sig``
  gives JAX's label.
- ``watch_compiles``: a cold call (an argument signature the site has not
  seen) records one event, a repeated one nothing; nested watched calls
  record the outermost; a raising call records nothing.
- The port's versions of JAX's sentinel and ledger cases
  (``tests/test_steplog.py``, ``tests/test_kv_quant.py``'s plan test): the
  ledger tiles a real chunk and drains the events onto the step that paid
  them; an induced post-fence event surfaces in the ledger, in
  ``xla.compiles_post_fence`` and in the brain's ``/health`` warning;
  ``warm_restart`` re-arms the fence; the plan equals the measured weight and
  KV bytes.
- ``engine_hbm_plan`` and the measured weight and KV bytes equal the JAX
  engine's at test-tiny (bf16 and int8 weights; dense, and paged at bf16,
  int8 and int4); ``hbm_budget`` byte-equal to JAX's.
- ``audit_dequant``: one weight-sized int8 -> bf16 copy a quantized matmul
  of a decode step (``_qe``), none at bf16 weights.
- ``require_card`` raises here (no card), and never re-executes the process.
"""

import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from tpu_voice_agent.models import llama as jl
from tpu_voice_agent.serve import DecodeEngine as JDense
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.utils import compilewatch as jcw
from tpu_voice_agent.utils import hbm_budget as jbudget
from tpu_voice_agent.utils import hbmledger as jledger
from tpu_voice_agent.utils import tracing as jt
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.models import llama as tl
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.services import brain
from tpu_voice_agent_torch.services.resilience import Deadline
from tpu_voice_agent_torch.utils import compilewatch as cw
from tpu_voice_agent_torch.utils import devinit, hbm_budget, perfdiag
from tpu_voice_agent_torch.utils.hbmledger import (
    engine_hbm_plan,
    hbm_report,
    measure_hbm,
    record_hbm_gauges,
)
from tpu_voice_agent_torch.utils.steplog import STAGES, get_steplog
from tpu_voice_agent_torch.utils.tracing import get_metrics


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_global_telemetry():
    """Every test starts with an empty step ring, a disarmed and zeroed
    watcher and every site cold, and leaves them so: all are process-global
    (an armed fence left behind would tag other modules' calls)."""
    for reset in (get_steplog().clear, cw.get_compile_watcher().reset, cw.forget_signatures):
        reset()
    yield
    for reset in (get_steplog().clear, cw.get_compile_watcher().reset, cw.forget_signatures):
        reset()


@pytest.fixture(scope="module")
def scope_engine():
    """JAX's scope engine: test-tiny, 2 dense slots, buckets (96, 192)."""
    return DecodeEngine(preset="test-tiny", max_len=768, batch_slots=2,
                        prefill_buckets=(96, 192), device="cpu")


def _batcher(engine, **kw):
    kw.setdefault("chunk_steps", 7)
    kw.setdefault("max_new_tokens", 16)
    return ContinuousBatcher(engine, **kw)


# ------------------------------------------------- the watcher against JAX's


def _drop_times(x):
    if isinstance(x, dict):
        return {k: _drop_times(v) for k, v in x.items() if k != "t_s"}
    if isinstance(x, list):
        return [_drop_times(v) for v in x]
    return x


SCENARIOS = {
    # (knobs, [op, ...]): op is ("rec", site, ms, sig), ("arm", reason),
    # ("disarm",), ("sleep", s) or ("take",)
    "defaults": ({}, [("rec", "engine.prefill_row", 12.5, "int32[1,96]"),
                      ("rec", "llama.forward", 3.25, "int32[2,1]"), ("take",),
                      ("arm", "warmup complete"),
                      ("rec", "engine.prefill_row", 40.125, "int32[1,192]"),
                      ("disarm",), ("rec", "stt._append_cross_kv", 1.0, "")]),
    "expected": ({"XLA_EXPECTED_COMPILES": "stt.,spec."},
                 [("arm", "test"), ("rec", "stt._stt_decode_loop", 7.0, "a"),
                  ("rec", "spec.spec_verify_step", 2.0, "b"),
                  ("rec", "paged.paged_chunk_decode_loop", 9.5, "c")]),
    "quiet": ({"XLA_FENCE_QUIET_S": "0.01"},
              [("rec", "engine._first_token", 1.0, "x"), ("sleep", 0.03),
               ("rec", "engine._decode_step", 2.0, "y"), ("take",),
               ("rec", "engine._decode_step", 3.0, "z")]),
    "ring": ({"XLA_SENTINEL_EVENTS": "3"},
             [("rec", f"site.{i}", float(i), f"s{i}") for i in range(5)] + [("take",)]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_compile_watcher_state_matches_jax(scenario, monkeypatch):
    knobs, ops = SCENARIOS[scenario]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    sides = []
    for mod, metrics in ((jcw, jt.get_metrics()), (cw, get_metrics())):
        w = mod.CompileWatcher()
        before = {n: metrics.snapshot()["counters"].get(n, 0.0)
                  for n in ("xla.compiles", "xla.compile_ms", "xla.compiles_post_fence")}
        taken = []
        for op in ops:
            if op[0] == "rec":
                w.record(*op[1:])
            elif op[0] == "arm":
                w.arm_fence(op[1])
            elif op[0] == "disarm":
                w.disarm_fence()
            elif op[0] == "sleep":
                time.sleep(op[1])
            else:
                taken.append(w.take_pending())
        after = metrics.snapshot()["counters"]
        sides.append({"state": _drop_times(w.state()), "events": _drop_times(w.events()),
                      "last2": _drop_times(w.events(last=2)), "taken": _drop_times(taken),
                      "pending": _drop_times(w.take_pending()), "armed": w.fence_armed,
                      "counters": {n: round(after.get(n, 0.0) - b, 6)
                                   for n, b in before.items()}})
    assert sides[0] == sides[1]
    if scenario == "ring":
        assert len(sides[1]["events"]) == 3 and sides[1]["state"]["compiles"] == 5


def test_shape_sig_is_jax_label():
    import jax.numpy as jnp

    jsig = jcw._shape_sig((jnp.zeros((2, 3), jnp.int32), {"a": 1}, [1, 2], 7, None), {"b": 2.5})
    tsig = cw._shape_sig((torch.zeros((2, 3), dtype=torch.int32), {"a": 1}, [1, 2], 7, None),
                         {"b": 2.5})
    assert tsig == jsig and "int32[2,3]" in tsig and "dict(1)" in tsig and "seq(2)" in tsig
    many = cw._shape_sig(tuple(torch.zeros((i + 1,)) for i in range(10)), {})
    assert many.endswith("…")


# ------------------------------------------------- watch_compiles units


def test_watch_compiles_counts_cold_calls_once():
    w = cw.get_compile_watcher()

    @cw.watch_compiles("test.unit_fn")
    def f(x):
        return x * 2

    f(torch.zeros((3,)))  # cold
    f(torch.ones((3,)))  # the same signature: nothing
    f(torch.zeros((5,)))  # a new shape: cold
    f(torch.zeros((5,), dtype=torch.float64))  # a new dtype: cold
    f(torch.zeros((5,), dtype=torch.float64))
    st = w.state()
    assert st["compiles"] == 3
    evs = w.events()
    assert [e["site"] for e in evs] == ["test.unit_fn"] * 3
    assert "float32[5]" in evs[1]["shape"] and "float64[5]" in evs[2]["shape"]
    assert st["post_fence_compiles"] == 0 and "warning" not in st


def test_call_key_reads_buckets_not_values():
    """Ints and floats are values (a slot, a temperature): no new event;
    bools, strings and frozen configs pick a kernel or a model: new ones."""
    w = cw.get_compile_watcher()

    @cw.watch_compiles("test.key_fn")
    def g(x, slot, temp, fresh=True, impl="kernels", cfg=None, cache=None):
        return x

    x = torch.zeros((2, 4))
    g(x, 0, 0.7)
    g(x, 5, 0.1)
    assert w.state()["compiles"] == 1
    g(x, 0, 0.7, fresh=False)
    g(x, 0, 0.7, impl="torch")
    g(x, 0, 0.7, cfg=tl.PRESETS["test-tiny"])
    g(x, 0, 0.7, cfg=tl.PRESETS["draft-tiny"])
    g(x, 0, 0.7, cache={"k": torch.zeros((1, 2, 8))})
    g(x, 0, 0.7, cache={"k": torch.zeros((1, 2, 16))})
    g(x, 0, 0.7, cache={"k": torch.ones((1, 2, 16))})
    assert w.state()["compiles"] == 7


def test_nested_calls_record_the_outermost_and_a_raise_records_nothing():
    w = cw.get_compile_watcher()

    @cw.watch_compiles("test.inner")
    def inner(x):
        return x + 1

    @cw.watch_compiles("test.outer")
    def outer(x, fail=False):
        y = inner(x)
        if fail:
            raise RuntimeError("boom")
        return y

    with pytest.raises(RuntimeError):
        outer(torch.zeros((4,)), fail=True)
    assert w.state()["compiles"] == 0  # nothing recorded, the signature still cold
    outer(torch.zeros((4,)))
    assert [e["site"] for e in w.events()] == ["test.outer"]
    inner(torch.zeros((4,)))  # marked seen inside the outer cold call
    assert w.state()["compiles"] == 1
    inner(torch.zeros((6,)))  # cold on its own: its own event
    assert [e["site"] for e in w.events()] == ["test.outer", "test.inner"]


def test_fence_flags_post_fence_events_with_warning():
    w = cw.get_compile_watcher()

    @cw.watch_compiles("test.fence_fn")
    def g(x):
        return x + 1

    g(torch.zeros((2,)))
    w.arm_fence("test warm")
    g(torch.zeros((4,)))  # the post-fence cold call
    st = w.state()
    assert st["fence_armed"] and st["fence_reason"] == "test warm"
    assert st["post_fence_compiles"] == 1
    assert "recompile(s) after the warmup fence" in st["warning"]
    assert "test.fence_fn" in st["warning"]
    pend = w.take_pending()  # handed to the step ledger exactly once
    assert len(pend) == 2 and pend[-1]["post_fence"]
    assert w.take_pending() == []


def test_sentinel_off_passes_callables_through(monkeypatch):
    monkeypatch.setenv("XLA_SENTINEL", "0")

    def h(x):
        return x

    assert cw.watch_compiles("test.off")(h) is h


def test_build_records_its_own_event(monkeypatch, tmp_path):
    """A build that compiles is one ``ops._lib.build`` event with its wall
    (nvcc stood in for by a script that writes the objects)."""
    from tpu_voice_agent_torch.ops import _lib

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then shift; "
                    ": > \"$1\"; fi; shift; done\n")
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    monkeypatch.setenv("TPU_VOICE_CACHE_DIR", str(tmp_path / "cache"))
    path = _lib.build()
    assert path.exists() and not _lib.BUILD_INFO["cached"]
    ev, = cw.get_compile_watcher().events()
    assert ev["site"] == "ops._lib.build" and ev["shape"] == f"nvcc {len(_lib.SOURCES)} sources"
    assert ev["ms"] == pytest.approx(_lib.BUILD_INFO["seconds"] * 1e3, abs=1e-3)
    _lib.build()  # cached: no second event
    assert cw.get_compile_watcher().state()["compiles"] == 1


# ------------------------------------------------- the scheduler plane


def test_ledger_accounts_chunk_wall_and_drains_the_events(scope_engine):
    w = cw.get_compile_watcher()
    bat = _batcher(scope_engine)
    res = bat.generate_many(["turn on the lights", "play some jazz"])
    assert all(r.error is None for r in res) or all(r.steps > 0 for r in res)
    steps = [s for s in get_steplog().steps() if s.get("occupancy")]
    assert steps, "decode chunks must land in the ring"
    for s in steps:
        acct = sum(s["stages"].values()) / s["wall_ms"]
        assert acct >= 0.95, f"only {acct:.1%} of step {s['seq']} accounted"
        assert set(s["stages"]) <= set(STAGES)
    assert steps[0]["occupancy"] >= 1
    assert sum(s.get("tokens", 0) for s in steps) >= sum(len(r.token_ids) for r in res)
    # every cold call of the run lands on exactly one step, named
    evs = [ev for s in get_steplog().steps() for ev in s["events"]]
    assert len(evs) == w.state()["compiles"] > 0
    assert {"engine.prefill_row", "engine.chunk_decode_loop"} <= {ev["site"] for ev in evs}
    assert all(set(ev) == {"site", "ms", "shape", "t_s", "post_fence"} for ev in evs)
    snap = get_metrics().snapshot()
    assert snap["latency_ms"]["engine.step.wall"]["count"] >= len(steps)
    assert snap["counters"]["engine.step.compile_stalls"] >= len(evs)
    # the same prompts again: every signature is warm, nothing recorded
    before = w.state()["compiles"]
    get_steplog().clear()
    _batcher(scope_engine).generate_many(["turn on the lights", "play some jazz"])
    assert w.state()["compiles"] == before
    assert all(s["events"] == [] for s in get_steplog().steps())


def test_induced_post_fence_event_surfaces_everywhere(scope_engine):
    """The acceptance drill: warm the 96-bucket, declare serving warm, then
    a prompt in the cold 192-bucket: the counter, the step ledger's event
    and the brain's /health warning all fire within one scrape."""
    w = cw.get_compile_watcher()
    bat = _batcher(scope_engine)
    bat.generate_many(["turn on the lights"])
    w.take_pending()
    get_steplog().clear()
    before = w.state()["compiles"]
    post0 = get_metrics().snapshot()["counters"].get("xla.compiles_post_fence", 0.0)

    w.arm_fence("warmup complete")
    ids = scope_engine.tokenizer.encode("turn on the lights and play jazz", bos=True)
    long_ids = (ids * ((120 // len(ids)) + 1))[:120]  # 96 < n <= 192
    bat.submit(list(long_ids))
    bat.run_until_done()

    st = w.state()
    assert st["compiles"] > before and st["post_fence_compiles"] >= 1 and "warning" in st
    assert get_metrics().snapshot()["counters"]["xla.compiles_post_fence"] > post0
    evs = [ev for s in get_steplog().steps() for ev in (s.get("events") or [])]
    assert any(ev["post_fence"] and "prefill" in ev["site"] for ev in evs), evs
    assert any("int32[1,192]" in ev["shape"] for ev in evs), evs
    status, body, _ = brain.BrainApp(brain.RuleBasedParser()).health()
    cs = body["compile_sentinel"]
    assert cs["post_fence_compiles"] >= 1
    assert "recompile(s) after the warmup fence" in cs["warning"]
    assert body["last_step"]["stages"], "/health carries the last step"


def test_all_admissions_shed_still_records_a_step(scope_engine):
    bat = _batcher(scope_engine)
    bat.submit("turn on the lights", deadline=Deadline(0.0))
    bat.step()
    assert bat.results, "expired request must shed at dequeue"
    steps = get_steplog().steps()
    assert steps and steps[-1]["occupancy"] == 0 and steps[-1]["tokens"] == 0
    assert "admit" in steps[-1]["stages"]


def test_steplog_off_is_token_identical(scope_engine):
    log = get_steplog()
    on = _batcher(scope_engine).generate_many(["dim the bedroom lights", "what time is it"])
    log.enabled = False
    try:
        off = _batcher(scope_engine).generate_many(["dim the bedroom lights",
                                                    "what time is it"])
    finally:
        log.enabled = True
    assert [r.token_ids for r in on] == [r.token_ids for r in off]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_warm_restart_rearms_the_fence(scope_engine, layout):
    w = cw.get_compile_watcher()
    eng = scope_engine if layout == "dense" else PagedDecodeEngine(
        preset="test-tiny", max_len=256, batch_slots=2, prefill_buckets=(64,), device="cpu",
        init_weights=False)
    assert not w.fence_armed
    eng.warm_restart()
    assert w.fence_armed and w.state()["fence_reason"] == "warm_restart"


# ------------------------------------------------------------ HBM ledger


def _engine_pair(layout: str, tier, quant, prefix: bool = False):
    """The JAX engine at test-tiny and the port's on its bridged weights."""
    kw = dict(preset="test-tiny", max_len=512, batch_slots=2, prefill_buckets=(64, 128),
              quant=quant)
    if layout == "paged":
        jeng = JPaged(kv_quant=tier, kernels="xla", **kw)
        teng = PagedDecodeEngine(kv_quant=tier or "off", init_weights=False, device="cpu", **kw)
    else:
        jeng = JDense(kernels="xla", **kw)
        teng = DecodeEngine(init_weights=False, device="cpu", **kw)
    teng.load_params(bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jeng.params)))
    if prefix:
        samples = ("you are a browser agent. search for shoes", "you are a browser agent. go back")
        assert jeng.set_prompt_prefix(*samples) == teng.set_prompt_prefix(*samples) > 0
    return jeng, teng


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("layout,tier,prefix", [("dense", None, False), ("dense", None, True),
                                                ("paged", None, False), ("paged", "int8", False),
                                                ("paged", "int4", False)])
def test_hbm_plan_and_measured_bytes_equal_jax(layout, tier, prefix, quant):
    jeng, teng = _engine_pair(layout, tier, quant, prefix)
    assert engine_hbm_plan(teng) == jledger.engine_hbm_plan(jeng)
    tm, jm = measure_hbm(teng), jledger.measure_hbm(jeng)
    assert (tm["weights_bytes"], tm["kv_pool_bytes"]) == (jm["weights_bytes"], jm["kv_pool_bytes"])
    assert tm["workspace_bytes"] == 0  # the CPU: no allocator view
    assert hbm_report(teng)["drift"] == jledger.hbm_report(jeng)["drift"]


def test_hbm_plan_matches_measured_weights_and_kv(scope_engine):
    plan, meas = engine_hbm_plan(scope_engine), measure_hbm(scope_engine)
    assert meas["weights_bytes"] == plan["weights_bytes"]
    assert meas["kv_pool_bytes"] == plan["kv_pool_bytes"]
    rep = hbm_report(scope_engine)
    assert abs(rep["drift"]) < 0.02 and rep["plan"]["total_bytes"] > 0


@pytest.mark.parametrize("tier", [None, "int8", "int4"])
def test_hbm_plan_matches_measured_kv(tier):
    """JAX's ``test_kv_quant.py`` plan case: the plan's KV bytes equal the
    pool and its scale planes under every tier."""
    eng = PagedDecodeEngine(preset="test-tiny", max_len=512, batch_slots=2,
                            prefill_buckets=(64,), kv_quant=tier or "off",
                            init_weights=False, device="cpu")
    plan = engine_hbm_plan(eng)
    assert plan["kv_pool_bytes"] == measure_hbm(eng)["kv_pool_bytes"]
    assert eng.kv_bytes_per_block * eng.allocator.n_blocks == plan["kv_pool_bytes"]


def test_hbm_gauges_exported_and_throttled(scope_engine, monkeypatch):
    rep = record_hbm_gauges(scope_engine, force=True)
    assert rep is not None
    g = get_metrics().gauges()
    for name in ("hbm.weights_bytes", "hbm.kv_pool_bytes", "hbm.workspace_bytes",
                 "hbm.plan_total_bytes", "hbm.plan_drift"):
        assert name in g, name
    assert g["hbm.weights_bytes"] == rep["measured"]["weights_bytes"]
    assert record_hbm_gauges(scope_engine, min_interval_s=60.0) is None  # throttled
    monkeypatch.setenv("HBM_DRIFT_WARN", "-1")  # any drift is past it
    n0 = get_metrics().snapshot()["counters"].get("hbm.drift_events", 0.0)
    record_hbm_gauges(scope_engine, force=True)
    assert get_metrics().snapshot()["counters"]["hbm.drift_events"] == n0 + 1


def test_batcher_exports_the_ledger_and_health_carries_it(monkeypatch):
    monkeypatch.setenv("HBM_LEDGER_S", "0")
    eng = PagedDecodeEngine(preset="test-tiny", max_len=512, batch_slots=2,
                            prefill_buckets=(64, 128), kv_quant="int8", device="cpu")
    _batcher(eng).generate_many(["scroll down"])
    g = get_metrics().gauges()
    assert g["hbm.kv_pool_bytes"] == measure_hbm(eng)["kv_pool_bytes"]
    assert g["hbm.plan_drift"] == hbm_report(eng)["drift"]
    parser = brain.BatchedEngineParser(eng, max_new_tokens=8)
    try:
        status, body, _ = brain.BrainApp(parser).health()
    finally:
        parser.close()
    assert set(body["compile_sentinel"]) >= set(jcw.CompileWatcher().state())
    assert {"hbm.weights_bytes", "hbm.kv_pool_bytes", "hbm.plan_drift"} <= set(body["hbm"])
    assert body["hbm"]["hbm.kv_pool_bytes"] == measure_hbm(eng)["kv_pool_bytes"]


def test_ledger_failure_never_fails_a_step(scope_engine, monkeypatch):
    from tpu_voice_agent_torch.serve import scheduler

    def broken(engine):
        raise RuntimeError("ledger read failed")

    monkeypatch.setattr(scheduler, "record_hbm_gauges", broken)
    res = _batcher(scope_engine).generate_many(["scroll down"])
    assert res[0].steps > 0


@pytest.mark.parametrize("case", [
    dict(name="flagship"),
    dict(name="llama3-8b", pp=1, tp=1, slots=8, max_len=8192, quant="int8"),
    dict(name="llama3-8b", pp=2, tp=2, slots=16, max_len=4096, quant=None),
    dict(name="mixtral-8x7b", pp=4, tp=2, slots=8, max_len=2048, quant="int8"),
    dict(name="tinyllama-1.1b", pp=1, tp=1, slots=32, max_len=2048, quant="int8"),
])
def test_hbm_budget_equals_jax(case):
    if case["name"] == "flagship":
        t, j = hbm_budget.flagship_70b_breakdown(), jbudget.flagship_70b_breakdown()
    else:
        kw = dict(batch_slots=case["slots"], max_len=case["max_len"], quant=case["quant"])
        t = hbm_budget.pp_tp_hbm_per_chip(tl.PRESETS[case["name"]], case["pp"], case["tp"], **kw)
        j = jbudget.pp_tp_hbm_per_chip(jl.PRESETS[case["name"]], case["pp"], case["tp"], **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.total == j.total and t.row() == j.row()
    assert t.fraction_of() == j.fraction_of()
    assert t.fraction_of(80 * 10**9) == j.fraction_of(80 * 10**9)
    assert hbm_budget.V5E_HBM_PER_CHIP == jbudget.V5E_HBM_PER_CHIP
    assert hbm_budget.USABLE_FRACTION == jbudget.USABLE_FRACTION


# ------------------------------------------------------------ perfdiag


@pytest.mark.parametrize("quant", [None, "int8"])
def test_audit_dequant_finds_one_copy_per_int8_matmul(quant):
    """A test-tiny decode step: an int8 engine materialises one bf16 copy
    of each quantized matmul weight (``_qe``: wq, wk, wv, wo, w_gate, w_up,
    w_down a layer, and lm_head), a bf16 engine none."""
    eng = DecodeEngine(preset="test-tiny", max_len=256, prefill_buckets=(64,), quant=quant,
                       device="cpu")
    cache_before = eng.cache["k"].clone()
    events = perfdiag.decode_step_profile(eng)
    assert torch.equal(eng.cache["k"], cache_before)  # the engine's cache untouched
    cfg = eng.cfg
    smallest = cfg.dim * cfg.n_kv_heads * cfg.head_dim * 2  # wk's bf16 copy
    rep = perfdiag.audit_dequant(events, min_bytes=smallest)
    assert rep["scanned_instructions"] == len(events) > 0
    want = 7 * cfg.n_layers + 1 if quant == "int8" else 0
    assert len(rep["findings"]) == want, rep["findings"]
    for op, dtype, shape, mb, what in rep["findings"]:
        assert (op, dtype, what) == ("copy_", "bfloat16", "int8 dequant")
        assert int(np.prod(shape)) * 2 >= smallest
    assert perfdiag.audit_dequant(events)["findings"] == []  # none reach the 8 MB default


def test_capture_profile_and_marginal_slope(tmp_path):
    eng = DecodeEngine(preset="test-tiny", max_len=256, prefill_buckets=(64,), device="cpu")
    path = perfdiag.capture_profile(eng, "scroll down", str(tmp_path / "trace"),
                                    max_new_tokens=4)
    with open(path) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::") for e in trace["traceEvents"])
    slope, span = perfdiag.marginal_ms_per_token(eng, "scroll down", lengths=(4, 12), tries=1,
                                                 with_steps=True)
    assert span is None or span[0] < span[1]
    assert slope is None or slope > 0


# ------------------------------------------------------------ devinit


def test_require_card_raises_here_and_never_reexecs(monkeypatch):
    def no_exec(*a, **kw):
        raise AssertionError("the port never re-executes the process")

    monkeypatch.setattr(os, "execve", no_exec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devinit.require_card(timeout_s=1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devinit.require_card_unless_cpu(None)
    assert devinit.require_card_unless_cpu("cpu") is None
    for name in ("reexec_on_cpu", "pin_platform_from_env", "devices_with_watchdog"):
        assert not hasattr(devinit, name)


def test_require_card_names_the_card_on_a_hang_and_raises_on_a_failure(monkeypatch):
    said = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(devinit, "_on_hang", said.append)
    monkeypatch.setattr(devinit, "_touch", lambda i: time.sleep(0.3) or "a card")
    assert devinit.require_card(timeout_s=0.05, index=1) == "a card"
    assert len(said) == 1 and "cuda:1" in said[0] and "hung" in said[0]

    def fails(i):
        raise OSError("context creation failed")

    monkeypatch.setattr(devinit, "_touch", fails)
    with pytest.raises(RuntimeError, match="cuda:0 failed: context creation failed"):
        devinit.require_card(timeout_s=5.0)
    assert len(said) == 1  # the watchdog stood down
