"""The port's DecodeEngine against the JAX package's, token for token.

Both engines serve test-tiny on ONE weight tree (the JAX engine's random
init, moved across with ``bridge``), cache the few-shot prompt prefix, and
decode greedily under the intent grammar: with fast-forward 8 (every step a
(1, 9) block through K3) and with it off (T=1 steps through K2). The JAX
engine runs its Pallas kernels in interpret mode; the port's wrappers run
their plain versions on CPU tensors. Greedy ids must be identical: any
difference in the arithmetic large enough to flip an argmax fails the test.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_voice_agent.serve import DecodeEngine as JEngine
from tpu_voice_agent.services.brain import install_prompt_prefix as j_install
from tpu_voice_agent.services.prompts import render_prompt
from tpu_voice_agent_torch import bridge
from tpu_voice_agent_torch.serve.engine import DecodeEngine
from tpu_voice_agent_torch.services.brain import install_prompt_prefix

PROMPTS = [("search for wireless headphones", {}),
           ("open the second result", {"last_query": "wireless headphones"})]
KW = dict(preset="test-tiny", max_len=1024, prefill_buckets=(1024,))


@pytest.fixture(scope="module")
def weights():
    eng = JEngine(kernels="pallas", **KW)
    return jax.tree_util.tree_map(np.asarray, eng.params)


@pytest.mark.parametrize("ff", [8, 0])
def test_generate_matches_jax_engine(weights, ff):
    jeng = JEngine(kernels="pallas", fast_forward=ff, init_weights=False, **KW)
    jeng.load_params(jax.device_put(weights))
    teng = DecodeEngine(fast_forward=ff, init_weights=False, device="cpu", **KW)
    teng.load_params(bridge.params_from_numpy(weights))
    assert j_install(jeng) == install_prompt_prefix(teng) > 800
    for text, ctx in PROMPTS:
        prompt = render_prompt(text, ctx)
        jres = jeng.generate(prompt, max_new_tokens=40)
        tres = teng.generate(prompt, max_new_tokens=40)
        assert tres.token_ids == jres.token_ids
        assert (tres.steps, tres.finished, tres.error) == (jres.steps, jres.finished, jres.error)
        assert tres.cached_tokens == len(teng.prefix_ids)
        if ff:
            assert tres.forwards < tres.steps  # chain tokens rode the forwards
        else:
            assert tres.forwards == jres.forwards


def test_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine()


def test_explicit_cpu_engine_runs_the_plain_versions():
    from tpu_voice_agent_torch import ops

    ops.reset_launch_counts()
    eng = DecodeEngine(preset="test-tiny", max_len=256, prefill_buckets=(64, 128),
                       fast_forward=8, device="cpu")
    res = eng.generate(render_prompt("go back", {})[-200:], max_new_tokens=12)
    assert res.steps == 12 and res.error is None
    assert eng.kernels == "kernels" and eng.device.type == "cpu"
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
