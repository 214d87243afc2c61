"""The distilled intent checkpoint on the quantized paged pool: the port
against recordings of the JAX package's KV_QUANT tiers.

``tpu_voice_agent_torch/data/intent_golden_kvquant.json`` holds, for each of
``int8`` and ``int4``, the JAX package's batched parse of every golden
utterance: its ``PagedDecodeEngine`` with 15 slots (the distilled prompt,
cache 512, prefill buckets (64, 128), fast-forward 0) behind its
``ContinuousBatcher`` (chunk 16, 300 new tokens), greedy and
grammar-constrained, on its Pallas kernels (interpret mode on the CPU: K1
over each fresh prefill's quantize-dequantize round trip, K8 every step). It
also holds the JAX ``kv_quant_differential`` on ``GOLDEN_INTENT_CASES[:6]``
at the JAX test's setup (``tests/test_kv_quant.py``: the few-shot prefix,
cache 2048, buckets (256, 512, 1024), two slots). These tests hold the
port's CPU path to both, token for token and ratio for ratio, and the floors
the JAX test pins. ``chip_smoke.py``'s ``kvquant_golden`` phase holds the
card to the same file.

Regenerate (JAX on the CPU, about a minute):

    JAX_PLATFORMS=cpu python tests/test_torch_kvquant_golden.py --write
"""

import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tpu_voice_agent.evals import golden as jgolden  # noqa: E402
from tpu_voice_agent.models.llama import LlamaConfig  # noqa: E402
from tpu_voice_agent.serve import PagedDecodeEngine as JPaged  # noqa: E402
from tpu_voice_agent.serve.scheduler import ContinuousBatcher as JBatcher  # noqa: E402
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install  # noqa: E402
from tpu_voice_agent.train import distill  # noqa: E402
from tpu_voice_agent_torch import distilled  # noqa: E402
from tpu_voice_agent_torch.evals.golden import (  # noqa: E402
    GOLDEN_INTENT_CASES,
    kv_quant_differential,
)
from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine  # noqa: E402
from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher  # noqa: E402
from tpu_voice_agent_torch.services.brain import install_prompt_prefix  # noqa: E402

TIERS = ("int8", "int4")
# the batched golden run, as chip_smoke.py's batch_golden phase sets it up
SLOTS, BUCKETS, MAX_NEW = 15, (64, 128), 300
# the differential, as tests/test_kv_quant.py sets it up
DIFF_CASES, DIFF_BUCKETS = 6, (256, 512, 1024)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: intra-op threads buy nothing, and under the
    suite's parallel workers every process's threads contend for the same
    cores (a file that takes 20 s alone took 15 minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_batched(cfg, params, tier):
    eng = JPaged(cfg=dataclasses.replace(cfg, max_seq_len=512), max_len=512,
                 prefill_buckets=BUCKETS, batch_slots=SLOTS, kv_quant=tier,
                 init_weights=False, kernels="pallas")
    eng.load_params(params)
    return eng


def write_data() -> None:
    cfg, params = distill.load_ckpt("checkpoints", distill.INTENT_CKPT, LlamaConfig)
    params = jax.device_put(params)
    cases = [(c.text, dict(c.context)) for c in jgolden.GOLDEN_INTENT_CASES]
    prompts = [distill.distilled_prompt(t, c) for t, c in cases]
    tiers = {}
    for tier in TIERS:
        res = JBatcher(_jax_batched(cfg, params, tier), chunk_steps=16,
                       max_new_tokens=MAX_NEW).generate_many(prompts)
        tiers[tier] = [{"text": t, "context": c, "token_ids": r.token_ids, "output": r.text,
                        "finished": r.finished} for (t, c), r in zip(cases, res)]

    def make_engine(tier):
        eng = JPaged(cfg=cfg, max_len=2048, batch_slots=2, prefill_buckets=DIFF_BUCKETS,
                     kv_quant=tier, init_weights=False, kernels="pallas")
        eng.load_params(params)
        j_install(eng)
        return eng

    diff = jgolden.kv_quant_differential(make_engine, jgolden.GOLDEN_INTENT_CASES[:DIFF_CASES])
    distilled.KVQUANT_GOLDEN_JSON.write_text(json.dumps({
        "source": f"checkpoints/{distill.INTENT_CKPT} through the JAX package's "
                  f"PagedDecodeEngine(batch_slots={SLOTS}, max_len=512, prefill_buckets="
                  f"{BUCKETS}, kv_quant=tier, kernels='pallas') behind ContinuousBatcher("
                  f"chunk_steps=16, max_new_tokens={MAX_NEW}), distilled_prompt, greedy "
                  "(interpret mode on the CPU); differential: evals.golden."
                  f"kv_quant_differential on GOLDEN_INTENT_CASES[:{DIFF_CASES}] as "
                  "tests/test_kv_quant.py sets it up, on the Pallas kernels",
        "tiers": tiers, "differential": diff}, indent=1) + "\n")


@pytest.fixture(scope="module")
def port_weights():
    return distilled.load_distilled(device="cpu")


@pytest.fixture(scope="module")
def recording():
    return distilled.kvquant_golden_records()


def test_recording_covers_the_golden_set(recording):
    for tier in TIERS:
        recs = recording["tiers"][tier]
        assert [r["text"] for r in recs] == [c.text for c in GOLDEN_INTENT_CASES]
        assert all(r["finished"] for r in recs)


@pytest.mark.parametrize("tier", TIERS)
def test_port_batched_parses_equal_the_jax_recording(port_weights, recording, tier):
    cfg, params = port_weights
    eng = PagedDecodeEngine(cfg=dataclasses.replace(cfg, max_seq_len=512), max_len=512,
                            prefill_buckets=BUCKETS, batch_slots=SLOTS, kv_quant=tier,
                            init_weights=False, device="cpu")
    eng.load_params(params)
    recs = recording["tiers"][tier]
    res = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=MAX_NEW).generate_many(
        [distilled.distilled_prompt(r["text"], r["context"]) for r in recs])
    for rec, r in zip(recs, res):
        assert r.error is None
        assert r.token_ids == rec["token_ids"], rec["text"]
        assert r.text == rec["output"] and r.finished == rec["finished"]
    assert eng.allocator.blocks_in_use == 0


def test_port_differential_equals_jax_and_holds_the_floors(port_weights, recording):
    cfg, params = port_weights

    def make_engine(tier):
        eng = PagedDecodeEngine(cfg=cfg, max_len=2048, batch_slots=2, prefill_buckets=DIFF_BUCKETS,
                                kv_quant=tier, init_weights=False, device="cpu")
        eng.load_params(params)
        install_prompt_prefix(eng)
        return eng

    out = kv_quant_differential(make_engine, GOLDEN_INTENT_CASES[:DIFF_CASES])
    assert out == recording["differential"]
    i8, i4 = out["tiers"]["int8"], out["tiers"]["int4"]  # tests/test_kv_quant.py:482-507
    assert i8["token_identical"] == i8["type_agreement"] == i8["grammar_valid"] == 1.0
    assert i4["grammar_valid"] == 1.0 and i4["type_agreement"] >= 0.5


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit(__doc__)
    write_data()
    print(f"wrote {distilled.KVQUANT_GOLDEN_JSON}")
