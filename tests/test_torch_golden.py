"""The distilled intent checkpoint in the port: weights and golden parses.

``tpu_voice_agent_torch/data`` carries the JAX package's
``checkpoints/intent-tiny-distilled`` as a flat npz (the card has no orbax)
and the JAX ``EngineParser(render=distilled_prompt)`` output on the golden
utterances as JSON. These tests hold the npz equal to the orbax tree, and the
port's CPU parses, the recorded JSON and a live JAX parse equal to each
other, token for token.

Regenerate both files (JAX on the CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_golden.py --write
"""

import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from tpu_voice_agent.evals.golden import GOLDEN_INTENT_CASES  # noqa: E402
from tpu_voice_agent.models.llama import LlamaConfig  # noqa: E402
from tpu_voice_agent.serve import DecodeEngine as JEngine  # noqa: E402
from tpu_voice_agent.services.brain import EngineParser as JParser  # noqa: E402
from tpu_voice_agent.train import distill  # noqa: E402
from tpu_voice_agent_torch import bridge, distilled  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These models are tiny: intra-op threads buy nothing, and under the
    suite's parallel workers every process's threads contend for the same
    cores (a file that takes 20 s alone took 15 minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_parser():
    """The JAX package's distilled ``EngineParser``, configured as
    ``distill.intent_engine_from`` but on its Pallas kernels (interpret mode
    here), the path it serves on its accelerator and the one the port's
    kernels mirror: K1 over the fresh block's own k/v, K2 over the bf16
    cache. On the CPU ``intent_engine_from`` would pick XLA's cache
    attention instead, which reads the prefill's k/v back rounded to bf16;
    one golden case has a top-2 logit margin of 0.007 that flips between
    the two."""
    cfg, params = distill.load_ckpt("checkpoints", distill.INTENT_CKPT, LlamaConfig)
    eng = JEngine(cfg=dataclasses.replace(cfg, max_seq_len=512), max_len=512,
                  prefill_buckets=(64, 128), init_weights=False, kernels="pallas")
    eng.load_params(jax.device_put(params))
    return cfg, params, JParser(eng, max_new_tokens=300, render=distill.distilled_prompt)


def _jax_parse(parser, text, context):
    """(GenerationResult, model_dump dict) of the JAX parser on one case."""
    res = parser.engine.generate(distill.distilled_prompt(text, context),
                                 max_new_tokens=parser.max_new_tokens,
                                 greedy=True, constrained=True)
    return res, parser.parse(text, context).model_dump()


def write_data() -> None:
    cfg, params, parser = _jax_parser()
    distilled.DATA_DIR.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(distilled.DISTILLED_NPZ,
                        **bridge.flatten(jax.tree_util.tree_map(np.asarray, params)))
    distilled.DISTILLED_META.write_text(json.dumps(
        {"source": f"checkpoints/{distill.INTENT_CKPT}", "config": dataclasses.asdict(cfg)},
        indent=1) + "\n")
    cases = []
    for case in GOLDEN_INTENT_CASES:
        res, resp = _jax_parse(parser, case.text, case.context)
        cases.append({"text": case.text, "context": case.context, "token_ids": res.token_ids,
                      "output": res.text, "response": resp})
    distilled.GOLDEN_JSON.write_text(json.dumps({
        "source": f"checkpoints/{distill.INTENT_CKPT} through the JAX package's "
                  "EngineParser(render=distilled_prompt), greedy, on its Pallas kernels "
                  "(interpret mode on the CPU)",
        "cases": cases}, indent=1) + "\n")


@pytest.fixture(scope="module")
def jax_side():
    return _jax_parser()


@pytest.fixture(scope="module")
def port_parser():
    cfg, params = distilled.load_distilled(device="cpu")
    return distilled.intent_engine_from(cfg, params, device="cpu")


def test_npz_equals_the_orbax_tree(jax_side):
    cfg, params, _ = jax_side
    flat = bridge.flatten(jax.tree_util.tree_map(np.asarray, params))
    with np.load(distilled.DISTILLED_NPZ) as z:
        assert sorted(z.files) == sorted(flat)
        for key, a in flat.items():
            assert z[key].dtype == a.dtype
            np.testing.assert_array_equal(z[key], a)
    meta = json.loads(distilled.DISTILLED_META.read_text())
    assert meta["config"] == dataclasses.asdict(cfg)


def test_recorded_cases_cover_the_golden_set():
    recs = distilled.golden_records()
    assert len(recs) >= 5
    assert [r["text"] for r in recs] == [c.text for c in GOLDEN_INTENT_CASES][:len(recs)]


def test_port_cpu_parses_equal_the_recorded_and_jax(jax_side, port_parser):
    _, _, jparser = jax_side
    for rec in distilled.golden_records():
        jres, jresp = _jax_parse(jparser, rec["text"], rec["context"])
        tresp = port_parser.parse(rec["text"], rec["context"])
        tres = port_parser.last_result
        assert tres.token_ids == rec["token_ids"] == jres.token_ids, rec["text"]
        assert tres.text == rec["output"] == jres.text
        assert tresp == rec["response"] == jresp
        assert tres.finished and tres.error is None


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit(__doc__)
    write_data()
    print(f"wrote {distilled.DISTILLED_NPZ} and {distilled.GOLDEN_JSON}")
