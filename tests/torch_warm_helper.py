"""Shared set-up of the warm-state tests (``tests/test_torch_handoff.py``,
``test_torch_disagg.py``, ``test_torch_prefix_feed.py``,
``test_torch_watchdog.py``): one float32 test-tiny weight tree, and a
``Side`` per package that builds paged radix engines on it and drives them
the same way, so each case runs once on the JAX package and once on the
port and the two are compared."""

from __future__ import annotations

import jax
import numpy as np

BUCKETS = (128, 256, 512, 1024, 2048)
KW = dict(preset="test-tiny", max_len=2048, batch_slots=2, prefill_buckets=BUCKETS)
TIERS = [None, "int8", "int4"]


def jax_weights() -> dict:
    """The JAX engine's seeded test-tiny tree, as float32 numpy."""
    from tpu_voice_agent.serve import PagedDecodeEngine

    eng = PagedDecodeEngine(kernels="xla", **KW)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), eng.params)


class Side:
    """One package's engines, batcher, transcripts, handoff module and
    metrics registry behind one surface. The JAX engines run their XLA path
    on the CPU (as the JAX package's own handoff tests do), the port its
    kernels' plain versions."""

    def __init__(self, name: str, weights: dict):
        self.name = name
        self.weights = weights
        if name == "jax":
            from tpu_voice_agent.serve import PagedDecodeEngine, handoff
            from tpu_voice_agent.serve.scheduler import ContinuousBatcher
            from tpu_voice_agent.services import brain
            from tpu_voice_agent.utils import get_metrics
        else:
            from tpu_voice_agent_torch.serve import handoff
            from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
            from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
            from tpu_voice_agent_torch.services import brain
            from tpu_voice_agent_torch.utils.tracing import get_metrics
        self.Paged, self.Batcher, self.brain = PagedDecodeEngine, ContinuousBatcher, brain
        self.handoff, self.metrics = handoff, get_metrics

    def engine(self, tier=None, radix: bool = True, max_nodes: int | None = None,
               prefix: bool = True, **kw):
        kw = {**KW, **kw}
        if self.name == "jax":
            extra = {} if max_nodes is None else {"radix_max_nodes": max_nodes}
            eng = self.Paged(kernels="xla", init_weights=False, radix_enable=radix,
                             kv_quant=tier, **extra, **kw)
            eng.load_params(jax.device_put(self.weights))
        else:
            from tpu_voice_agent_torch import bridge

            eng = self.Paged(init_weights=False, device="cpu", radix_enable=radix,
                             kv_quant=tier, **kw)
            if max_nodes is not None:
                eng.radix.max_nodes = max_nodes
            eng.load_params(bridge.params_from_numpy(self.weights))
        if prefix:
            self.brain.install_prompt_prefix(eng)
        return eng

    def transcripts(self, eng):
        return self.brain.SessionTranscripts(eng.tokenizer)

    def batcher(self, eng, max_new: int = 32, chunk_steps: int = 16):
        return self.Batcher(eng, chunk_steps=chunk_steps, max_new_tokens=max_new)

    def run(self, eng, prompts, max_new: int = 32):
        return self.batcher(eng, max_new).generate_many(prompts)

    def tree(self, eng):
        return eng.radix[0] if self.name == "jax" else eng.radix

    def prefix_blocks(self, eng) -> list[int]:
        return eng._prefix_blocks[0] if self.name == "jax" else eng._prefix_blocks

    def free_blocks(self, eng) -> int:
        return eng.allocator.free_blocks(0) if self.name == "jax" else \
            eng.allocator.free_blocks()

    def counter(self, name: str) -> float:
        return self.metrics().snapshot()["counters"].get(name, 0.0)

    def balanced(self, eng) -> None:
        """Every live block is the prefix's or the tree's (every slot is
        released): a leak or a double free breaks this."""
        assert eng.allocator.blocks_in_use == self.tree(eng).nodes, (
            self.name, eng.allocator.blocks_in_use, self.tree(eng).nodes)


def play(side: Side, eng, transcripts, turns, sid: str = "handoff-session", max_new: int = 32):
    """Drive ``turns`` as the session-aware brain does (prompt_for, then
    record); returns the per-turn results."""
    out = []
    for text, ctx in turns:
        prompt = transcripts.prompt_for(sid, text, ctx)
        r = side.run(eng, [prompt], max_new)[0]
        assert r.error is None, r.error
        transcripts.record(sid, prompt, r.token_ids)
        out.append(r)
    return out
