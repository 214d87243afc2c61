"""The port's tenancy plane (``serve/tenancy.py``) and its wiring into the
``ContinuousBatcher`` against the JAX package's.

JAX ``tests/test_tenancy.py``'s cases run against the port: the registry's
parser (equal to JAX's on the same specs), the plane's fair pick, idle
catch-up and ``FairLanes`` rank, the feature-off identity, the rate-limited
shed, preemption that resumes warm and token-identical, the tenant-salted
radix namespaces, the fairness hammer and the requeue rotation. Beside
them, the same seeded operation sequence drives JAX's ``TenancyPlane`` and
the port's to equal snapshots, and the batchers of both packages, tenancy
on, give equal tokens, with a preemption and without.

JAX's ``test_requeue_rotation_unsticks_small_requests`` fails on the
reference itself, run alone too: it asserts the small requests FINISH
before the oversized one, which random-weight answers of the full budget
do not promise. The port's case holds the contract beneath it: the
starved head rotates after ``SCHED_REQUEUE_MAX`` retries, so the small
requests are ADMITTED first, and all four finish clean.

One weight tree (a JAX engine's random init, float32) serves both sides;
the JAX engines run their Pallas kernels in interpret mode.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpu_voice_agent.serve import PagedDecodeEngine as JPaged
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher
from tpu_voice_agent.serve.tenancy import TenancyPlane as JPlane
from tpu_voice_agent.serve.tenancy import parse_tenant_classes as j_parse
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
from tpu_voice_agent_torch.serve.tenancy import (
    DEFAULT_TENANT,
    FairLanes,
    TenancyPlane,
    parse_tenant_classes,
    tenancy_enabled,
)
from tpu_voice_agent_torch.services.brain import install_prompt_prefix
from tpu_voice_agent_torch.utils.tracing import get_metrics

BUCKETS = (128, 256, 512, 1024, 2048)
KW = dict(preset="test-tiny", max_len=2048, prefill_buckets=BUCKETS)
PROMPTS = ["search for usb hubs", "scroll down", "go back", "sort by price",
           "take a screenshot", "search for keyboards"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module (the driver runs six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    eng = JPaged(kernels="pallas", batch_slots=1, **KW)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


def _paged(weights, batch_slots=2, radix=True, **kw):
    eng = PagedDecodeEngine(init_weights=False, device="cpu", batch_slots=batch_slots,
                            radix_enable=radix, **KW, **kw)
    eng.load_params(bridge.params_from_numpy(weights))
    install_prompt_prefix(eng)
    return eng


def _jpaged(weights, batch_slots=2, radix=True):
    eng = JPaged(kernels="pallas", init_weights=False, batch_slots=batch_slots,
                 radix_enable=radix, **KW)
    eng.load_params(jax.device_put(weights))
    j_install(eng)
    return eng


def _batcher(eng, chunk_steps=8, max_new=32, cls=ContinuousBatcher):
    return cls(eng, chunk_steps=chunk_steps, max_new_tokens=max_new)


# ------------------------------------------------------------- registry

SPECS = ["premium:4:slots=3:blocks=64:rps=20:p50=800, free:1:rps=2", "a:2,b:1", "", "solo"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_tenant_classes_spec(spec):
    classes = parse_tenant_classes(spec)
    jclasses = j_parse(spec)
    assert list(classes) == list(jclasses)
    for name, c in classes.items():
        j = jclasses[name]
        assert (c.name, c.weight, c.slots, c.blocks, c.rps, c.p50_ms) == (
            j.name, j.weight, j.slots, j.blocks, j.rps, j.p50_ms)
    assert classes[DEFAULT_TENANT].weight == 1.0
    if spec.startswith("premium"):
        p = classes["premium"]
        assert (p.weight, p.slots, p.blocks, p.rps, p.p50_ms) == (4.0, 3, 64, 20.0, 800.0)


@pytest.mark.parametrize("bad", ["premium:0", "premium:1:turbo=9", ":2", "premium:1:slots"])
def test_parse_tenant_classes_rejects_malformed(bad):
    with pytest.raises(ValueError) as jerr:
        j_parse(bad)
    with pytest.raises(ValueError) as err:
        parse_tenant_classes(bad)
    assert str(err.value) == str(jerr.value)


def test_tenancy_enabled_follows_knob(monkeypatch):
    monkeypatch.delenv("TENANT_CLASSES", raising=False)
    assert not tenancy_enabled()
    monkeypatch.setenv("TENANT_CLASSES", "  ")
    assert not tenancy_enabled()
    monkeypatch.setenv("TENANT_CLASSES", "premium:4")
    assert tenancy_enabled()


# ----------------------------------------------------- plane unit rules


def test_fair_pick_prefers_poorest_lane_with_headroom():
    plane = TenancyPlane(parse_tenant_classes("a:3:slots=1,b:1"))
    plane.charge("a", 30)  # vtime 10
    plane.charge("b", 30)  # vtime 30
    assert plane.pick(["a", "b"]) == 0
    plane.on_dequeue("a", admitted=True)  # a holds its one slot
    assert plane.pick(["a", "b"]) == 1
    assert plane.pick(["a"]) is None


def test_idle_lane_catchup_no_retroactive_credit():
    plane = TenancyPlane(parse_tenant_classes("busy:1,idle:1"))
    plane.on_queue("busy")
    plane.charge("busy", 1000)
    plane.on_queue("idle")
    assert plane.lane("idle").vtime == pytest.approx(1000.0)


def test_fairlanes_rank_composes_before_priority():
    lanes = FairLanes(parse_tenant_classes("premium:4,free:1"))
    lanes.charge("premium", 4.0)
    lanes.charge("free", 4.0)
    assert lanes.rank("premium") < lanes.rank("free")
    assert lanes.rank("unknown") == lanes.rank(None)


@pytest.mark.parametrize("seed", [0, 1])
def test_plane_matches_jax_under_a_seeded_op_sequence(seed):
    """Queue, dequeue, charge, release, pick, victim choice, preemption
    notes, cost folds and the rate limit (a huge rps: never throttled, so
    the clock plays no part): the same answers and snapshots."""
    spec = "gold:3:slots=2:blocks=8,silver:2:rps=1000000,bronze:1"
    rng = np.random.default_rng(seed)
    jp, tp = JPlane(j_parse(spec)), TenancyPlane(parse_tenant_classes(spec))
    names = ["gold", "silver", "bronze", "nobody", None]
    for _ in range(400):
        op = int(rng.integers(8))
        t = names[int(rng.integers(len(names)))]
        if op == 0:
            jp.on_queue(t), tp.on_queue(t)
        elif op == 1:
            adm = bool(rng.integers(2))
            jp.on_dequeue(t, adm), tp.on_dequeue(t, adm)
        elif op == 2:
            k = int(rng.integers(0, 40))
            jp.charge(t, k), tp.charge(t, k)
        elif op == 3:
            jp.on_release(t), tp.on_release(t)
        elif op == 4:
            ts = [names[int(i)] for i in rng.integers(len(names), size=int(rng.integers(0, 6)))]
            assert jp.pick(ts) == tp.pick(ts)
        elif op == 5:
            act = [(b, names[int(i)]) for b, i in enumerate(rng.integers(len(names), size=4))]
            wait = [names[int(i)] for i in rng.integers(len(names), size=3)]
            assert jp.over_budget_victim(act, wait) == tp.over_budget_victim(act, wait)
        elif op == 6:
            cost = {"prefill_flops": int(rng.integers(1000)), "decode_flops": int(rng.integers(99))}
            jp.fold_cost(t, cost), tp.fold_cost(t, cost)
            jp.note_preemption(t), tp.note_preemption(t)
        else:
            assert jp.admit(t) == tp.admit(t) is True
        assert jp.block_quota(t) == tp.block_quota(t)
    js, ts_ = jp.snapshot(), tp.snapshot()
    for snap in (js, ts_):
        for ent in snap["ledgers"].values():
            ent.pop("last_s")
    assert ts_ == js


# ------------------------------------------------- scheduler integration


def test_feature_off_identity(weights, monkeypatch):
    """With ``TENANT_CLASSES`` unset nothing is built, and the tokens equal
    the plane-on run's (fair admission may reorder, results may not
    change)."""
    monkeypatch.delenv("TENANT_CLASSES", raising=False)
    b_off = _batcher(_paged(weights))
    assert b_off.tenancy is None
    off = b_off.generate_many(PROMPTS[:4])
    monkeypatch.setenv("TENANT_CLASSES", "a:2,b:1")
    b_on = _batcher(_paged(weights))
    assert b_on.tenancy is not None
    rids = [b_on.submit(p, tenant=("a" if i % 2 == 0 else "b")) for i, p in enumerate(PROMPTS[:4])]
    b_on.run_until_done()
    for r_off, rid in zip(off, rids):
        assert r_off.error is None
        assert b_on.results[rid].token_ids == r_off.token_ids


def test_rate_limited_tenant_sheds_not_errors(weights, monkeypatch):
    """An over-rps burst is refused at submit with the retryable ``shed:``
    prefix: exactly the bucket's one request decodes."""
    monkeypatch.setenv("TENANT_CLASSES", "slowpoke:1:rps=1")
    b = _batcher(_paged(weights))
    t0 = get_metrics().snapshot()["counters"].get("tenant.throttled", 0)
    rids = [b.submit(PROMPTS[i % len(PROMPTS)], tenant="slowpoke") for i in range(5)]
    shed = [r for r in rids if r in b.results]
    assert len(shed) == 4
    for r in shed:
        assert b.results[r].error.startswith("shed: tenant slowpoke")
    b.run_until_done()
    survivor = [r for r in rids if r not in shed]
    assert len(survivor) == 1 and b.results[survivor[0]].error is None
    assert b.tenancy.snapshot()["lanes"]["slowpoke"]["throttled"] == 4
    assert get_metrics().snapshot()["counters"]["tenant.throttled"] == t0 + 4


def _preempt_run(eng, cls):
    b = _batcher(eng, max_new=48, cls=cls)
    r_free = b.submit(PROMPTS[0], tenant="free")
    b.step()  # free holds the only slot, one chunk decoded
    r_prem = b.submit(PROMPTS[1], tenant="premium")
    b.run_until_done()
    return b, b.results[r_free], b.results[r_prem]


def test_preemption_resumes_warm_and_token_identical(weights, monkeypatch):
    """A preempted request is released warm into its tenant's namespace,
    requeued, and finishes token-identical to an uncontended run, as in
    JAX (exactly, on the same weights)."""
    monkeypatch.setenv("TENANT_CLASSES", "premium:4,free:1")
    refs = {p: _batcher(_paged(weights, batch_slots=1), max_new=48).generate_many([p])[0]
            for p in PROMPTS[:2]}
    b, r_free, r_prem = _preempt_run(_paged(weights, batch_slots=1), ContinuousBatcher)
    lanes = b.tenancy.snapshot()["lanes"]
    assert lanes["free"]["preemptions"] >= 1
    for res, p in ((r_free, PROMPTS[0]), (r_prem, PROMPTS[1])):
        assert res.error is None
        assert res.token_ids == refs[p].token_ids
    _, j_free, j_prem = _preempt_run(_jpaged(weights, batch_slots=1), JBatcher)
    assert (r_free.token_ids, r_prem.token_ids) == (j_free.token_ids, j_prem.token_ids)
    assert (r_free.cached_tokens, r_prem.cached_tokens) == (j_free.cached_tokens,
                                                            j_prem.cached_tokens)


def test_tenancy_batch_matches_jax(weights, monkeypatch):
    """Four requests of three tenants (one unknown) on two slots, tenancy
    on in both packages: equal tokens, equal lanes' token counts."""
    monkeypatch.setenv("TENANT_CLASSES", "a:2:slots=1,b:1")
    tenants = ["a", "b", "a", "zzz"]
    out = []
    for eng, cls in ((_jpaged(weights), JBatcher), (_paged(weights), ContinuousBatcher)):
        b = _batcher(eng, cls=cls)
        rids = [b.submit(p, tenant=t) for p, t in zip(PROMPTS[2:6], tenants)]
        b.run_until_done()
        lanes = b.tenancy.snapshot()["lanes"]
        out.append(([b.results[r].token_ids for r in rids],
                    {k: (v["tokens"], v["active"], v["queued"]) for k, v in lanes.items()}))
    assert out[1] == out[0]


def test_radix_namespaces_are_tenant_salted(weights, monkeypatch):
    """Two tenants decoding the same prompt get their own salted chains;
    the pinned static prefix stays one shared node."""
    monkeypatch.setenv("TENANT_CLASSES", "a:1,b:1")
    eng = _paged(weights)
    b = _batcher(eng)
    ids = eng.tokenizer.encode(PROMPTS[0], bos=True) * 40  # fills whole blocks
    for t in ("a", "b"):
        rid = b.submit(ids, tenant=t)
        b.run_until_done()
        assert b.results.pop(rid).error is None
    nodes = list(eng.radix._nodes())
    salted = [n for n in nodes if n.ns is not None]
    assert {n.ns for n in salted} == {"a", "b"}
    assert len(salted) >= 2
    assert any(n.pinned and n.ns is None for n in nodes)
    assert eng.radix._ns_nodes == {"a": len([n for n in salted if n.ns == "a"]),
                                   "b": len([n for n in salted if n.ns == "b"])}


def test_radix_block_quota_evicts_the_tenants_own_leaves(weights, monkeypatch):
    """A tenant at its block quota pays with its own least-recent leaves:
    its node count stays at the quota, another tenant's chain stays."""
    monkeypatch.setenv("TENANT_CLASSES", "small:1:blocks=2,big:1")
    eng = _paged(weights)
    b = _batcher(eng)
    base = eng.tokenizer.encode(PROMPTS[3], bos=True)
    for t, reps in (("big", 100), ("small", 100), ("small", 130)):
        rid = b.submit(base * reps, tenant=t)
        b.run_until_done()
        assert b.results.pop(rid).error is None
    counts = eng.radix._ns_nodes
    assert counts["small"] == 2 and counts["big"] > 2


def test_fairness_race_hammer(weights, monkeypatch):
    """Submitter threads per tenant against a 2-slot batcher with
    preemption on: nothing lost or double-committed, no leaked block, and
    the token split over the contended window within 10 points of 3:1."""
    monkeypatch.setenv("TENANT_CLASSES", "premium:3,free:1")
    monkeypatch.setenv("SCHED_POOL_WAIT_S", "60")
    eng = _paged(weights, radix=False)
    free0 = eng.allocator.free_blocks()
    b = _batcher(eng, chunk_steps=8, max_new=16)
    per_thread, threads_per_tenant = 4, 3
    rids: dict[str, list[int]] = {"premium": [], "free": []}
    lock = threading.Lock()

    def submitter(tenant: str) -> None:
        for i in range(per_thread):
            rid = b.submit(PROMPTS[i % len(PROMPTS)], tenant=tenant)
            with lock:
                rids[tenant].append(rid)

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in ("premium", "free") for _ in range(threads_per_tenant)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 120
    contended_share = None
    while time.monotonic() < deadline:
        b.step()
        lanes = b.tenancy.snapshot()["lanes"]
        total = lanes["premium"]["tokens"] + lanes["free"]["tokens"]
        if (contended_share is None and total >= 96 and lanes["premium"]["queued"] > 0
                and lanes["free"]["queued"] > 0):
            contended_share = lanes["premium"]["tokens"] / total
        with lock:
            done = all(r in b.results for rs in rids.values() for r in rs)
        if done and not any(s.request_id >= 0 for s in b.slots):
            break
        time.sleep(0)
    for th in threads:
        th.join()
    all_rids = rids["premium"] + rids["free"]
    assert len(all_rids) == per_thread * threads_per_tenant * 2
    assert sorted(b.results) == sorted(all_rids)
    for r in all_rids:
        assert b.results[r].error is None, b.results[r].error
    assert eng.allocator.free_blocks() == free0
    assert contended_share is not None, "never observed a contended window"
    assert abs(contended_share - 0.75) <= 0.10, contended_share


def test_requeue_rotation_unsticks_small_requests(weights, monkeypatch):
    """A pool-starved head rotates to the back after ``SCHED_REQUEUE_MAX``
    head retries, so the small requests behind it are admitted before it;
    all four finish clean."""
    monkeypatch.delenv("TENANT_CLASSES", raising=False)
    monkeypatch.setenv("SCHED_POOL_WAIT_S", "60")
    monkeypatch.setenv("SCHED_REQUEUE_MAX", "2")
    eng = _paged(weights, radix=False, pool_blocks=16)
    b = _batcher(eng, chunk_steps=4, max_new=48)
    base = eng.tokenizer.encode(PROMPTS[3], bos=True)
    bs = eng.block_size
    pool = eng.allocator.free_blocks()
    big_blocks = max(n for n in (1, 2, 4, 8, 16) if n <= pool - 1)
    need = big_blocks * bs - bs // 2
    big_ids = (base * (need // len(base) + 1))[:need]
    occ_need = (pool - big_blocks + 1) * bs - bs // 2
    occ_ids = (base * (occ_need // len(base) + 1))[:occ_need]
    occupant = b.submit(occ_ids)
    b.step()
    big = b.submit(big_ids)
    small = [b.submit(p) for p in PROMPTS[1:3]]
    rot0 = get_metrics().snapshot()["counters"].get("scheduler.requeue_rotations", 0.0)
    admitted: list[int] = []
    for _ in range(300):
        b.step()
        for sl in b.slots:
            if sl.request_id >= 0 and sl.request_id not in admitted:
                admitted.append(sl.request_id)
        if all(r in b.results for r in (occupant, big, *small)):
            break
    for rid in (occupant, big, *small):
        assert rid in b.results and b.results[rid].error is None
    assert all(admitted.index(s) < admitted.index(big) for s in small)
    assert get_metrics().snapshot()["counters"]["scheduler.requeue_rotations"] > rot0
