"""The voice service on trained weights, the port beside the JAX stack.

Both voice services boot their STT from the same environment
(``VOICE_STT=whisper-ckpt:<repo>/checkpoints/<name>``, the port with
``VOICE_DEVICE=cpu``) and call a brain over the distilled intent checkpoint
(the JAX ``distill.intent_engine_from`` behind the aiohttp brain; the port's
``distilled.intent_engine_from`` behind ``BrainApp``), which both execute
against the JAX executor on ``FakePage``. The two scenarios of
``tests/test_neural_e2e.py`` go through each stack as 60 ms PCM16 frames, and
the finals and the intents must be equal:

- ``whisper-tiny-overfit`` (the checkpoint ``test_neural_e2e.py`` uses) must
  also read the acoustic font exactly, as that test asserts for JAX;
- ``whisper-tiny-heldout`` misreads some of it ("search for screenshot"), and
  the port must misread it the same way.
"""

import asyncio
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.http_helper import AppServer
from tpu_voice_agent.models.llama import LlamaConfig
from tpu_voice_agent.services.brain import build_app as build_jax_brain
from tpu_voice_agent.services.executor import SessionManager
from tpu_voice_agent.services.executor import build_app as build_executor
from tpu_voice_agent.services.executor.page import FakePage
from tpu_voice_agent.services.voice import VoiceConfig as JaxVoiceConfig
from tpu_voice_agent.services.voice import build_app as build_jax_voice
from tpu_voice_agent.train import distill
from tpu_voice_agent_torch import distilled, whisper_ckpt
from tpu_voice_agent_torch.services import brain, voice, ws

ROOT = Path(__file__).resolve().parents[1]
SIL = np.zeros(16_000, dtype=np.float32)
SCENARIOS = {
    "search": (["search for red shoes"], 1),
    "scroll_then_screenshot": (["scroll down", "take a screenshot"], 2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny models: intra-op threads buy nothing and contend under the
    suite's parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pcm16_frames(audio: np.ndarray, frame_ms: int = 60) -> list[bytes]:
    """Float audio -> 60 ms PCM16 frames, as the web client ships them."""
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    step = 16_000 * frame_ms // 1000 * 2
    return [pcm[i:i + step] for i in range(0, len(pcm), step)]


def stream(url: str, frames: list[bytes], n: int, timeout_s: float = 120.0) -> list:
    """Send every frame, then read until n utterances have reported their
    latency_budget (the last frame of each, executed or not)."""
    async def run():
        events = []
        c = await ws.connect(url + "/stream")
        try:
            for f in frames:
                await c.send_bytes(f)
            end = asyncio.get_running_loop().time() + timeout_s
            while sum(e["type"] == "latency_budget" for e in events) < n:
                assert asyncio.get_running_loop().time() < end, events
                try:
                    msg = await c.receive(timeout=1.0)
                except asyncio.TimeoutError:
                    continue
                assert msg.type == ws.TEXT, msg
                events.append(msg.json())
        finally:
            await c.close()
        return events

    return asyncio.run(run())


@pytest.fixture(scope="module")
def brains():
    """The two brains over the distilled checkpoint (shared by every case)."""
    icfg, iparams = distill.load_ckpt(str(ROOT / "checkpoints"), distill.INTENT_CKPT,
                                      LlamaConfig)
    jax_brain = AppServer(build_jax_brain(distill.intent_engine_from(icfg, iparams))).__enter__()
    cfg, params = distilled.load_distilled(device="cpu")
    server = brain.make_server(
        brain.BrainApp(distilled.intent_engine_from(cfg, params, device="cpu")), port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield {"jax": jax_brain.url, "port": f"http://127.0.0.1:{server.server_address[1]}"}
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    jax_brain.__exit__(None, None, None)


@pytest.fixture(scope="module")
def executor(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exec")
    manager = SessionManager(page_factory=FakePage.demo, artifacts_root=str(tmp / "art"),
                             uploads_dir=str(tmp / "up"))
    with AppServer(build_executor(manager)) as srv:
        yield srv


@pytest.fixture(scope="module", params=whisper_ckpt.CHECKPOINTS)
def stacks(request, brains, executor):
    name = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOICE_STT", f"whisper-ckpt:{ROOT / 'checkpoints' / name}")
        mp.setenv("VOICE_DEVICE", "cpu")
        jax_voice = AppServer(build_jax_voice(JaxVoiceConfig(
            brain_url=brains["jax"], executor_url=executor.url))).__enter__()
        port_voice = ws.ServerThread(voice.build_app(voice.VoiceConfig(
            brain_url=brains["port"], executor_url=executor.url))).__enter__()
    yield name, {"jax": jax_voice.url, "port": port_voice.url}
    port_voice.__exit__(None, None, None)
    jax_voice.__exit__(None, None, None)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_finals_and_intents_match_the_jax_stack(stacks, scenario):
    name, urls = stacks
    texts, n = SCENARIOS[scenario]
    audio = np.concatenate([x for t in texts for x in (whisper_ckpt.render_speech(t), SIL)])
    frames = pcm16_frames(audio)
    out = {}
    for side, url in urls.items():
        events = stream(url, frames, n)
        out[side] = {
            "finals": [e["text"] for e in events if e["type"] == "transcript_final"],
            # the STT confidence lanes (QUALITY_ENABLE defaults on in both)
            "confidence": [e.get("confidence") for e in events
                           if e["type"] == "transcript_final"],
            "intents": [e["data"]["intents"] for e in events if e["type"] == "intent"],
            "degraded": [e for e in events if e.get("degraded")],
            "results": [all(r.get("ok") for r in e["data"]["results"])
                        for e in events if e["type"] == "execution_result"],
        }
    assert out["port"] == out["jax"], json.dumps(out, indent=1)
    port = out["port"]
    assert not port["degraded"] and len(port["finals"]) == len(texts)
    assert all(set(c) == {"logp_mean", "logp_min", "logp_first", "repetition"}
               for c in port["confidence"])
    if name == "whisper-tiny-overfit":  # test_neural_e2e.py's assertions
        assert port["finals"] == texts
        if scenario == "search":
            assert port["intents"][0][0]["type"] == "search"
            assert port["intents"][0][0]["args"]["query"] == "red shoes"
        else:
            assert [i[0]["type"] for i in port["intents"]] == ["scroll", "screenshot"]
        assert port["results"] == [True] * n
