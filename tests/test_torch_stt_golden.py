"""The in-repo Whisper checkpoints in the port: weights and golden transcripts.

``tpu_voice_agent_torch/data`` carries the JAX package's
``checkpoints/whisper-tiny-overfit`` and ``-heldout`` as flat npz files (the
card has no orbax) and the JAX ``SpeechEngine(kernels="pallas")`` transcripts
of ``WHISPER_EVAL_TEXTS`` on both as JSON: the Pallas kernels (interpret mode
on the CPU) are the path the port's K1 and K5 mirror. These tests hold the
npz files equal to the orbax trees, and the port's CPU transcripts, the
recorded JSON and a live JAX run equal to each other, token for token.

Regenerate the files (JAX on the CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_stt_golden.py --write
"""

import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from tpu_voice_agent.models.whisper import WhisperConfig, init_self_cache  # noqa: E402
from tpu_voice_agent.serve.stt import SpeechEngine as JSpeech  # noqa: E402
from tpu_voice_agent.serve.stt import _stt_decode_loop  # noqa: E402
from tpu_voice_agent.train import distill  # noqa: E402
from tpu_voice_agent_torch import bridge, whisper_ckpt  # noqa: E402


def _jax_engine(name):
    """The JAX package's checkpoint engine, configured as
    ``distill.whisper_engine_from`` but on its Pallas kernels."""
    cfg, params = distill.load_ckpt("checkpoints", name, WhisperConfig)
    eng = JSpeech(cfg=cfg, frame_buckets=(cfg.max_audio_frames,), max_new_tokens=48,
                  init_weights=False, kernels="pallas")
    eng.load_params(jax.device_put(params))
    return cfg, params, eng


def jax_transcribe(eng, audio):
    """(token ids, text) of the JAX engine's transcribe(): its
    ``_encode_window`` + ``_stt_decode_loop``, reading the ids that
    ``_decode`` turns into text."""
    cross_kv, valid, _ = eng._encode_window(audio)
    cache = init_self_cache(eng.cfg, 1, dtype=eng._param_dtype)
    bos = jnp.asarray(list(eng.bos_ids), dtype=jnp.int32)[None, :]
    out, n, _, _ = _stt_decode_loop(eng.params, eng.cfg, cache, cross_kv, valid, bos,
                                    eng.suppress, max_new=eng.max_new_tokens,
                                    eos_id=eng.eos_id, pad_id=eng.pad_id,
                                    attn_impl=eng.kernels)
    ids = [int(t) for t in np.asarray(out)[0, :int(np.asarray(n)[0])]]
    return ids, eng.tokenizer.decode(ids).strip()


def write_data() -> None:
    whisper_ckpt.DATA_DIR.mkdir(parents=True, exist_ok=True)
    records = {}
    for name in whisper_ckpt.CHECKPOINTS:
        cfg, params, eng = _jax_engine(name)
        np.savez_compressed(whisper_ckpt.npz_path(name),
                            **bridge.flatten(jax.tree_util.tree_map(np.asarray, params)))
        whisper_ckpt.meta_path(name).write_text(json.dumps(
            {"source": f"checkpoints/{name}", "config": dataclasses.asdict(cfg)},
            indent=1) + "\n")
        records[name] = []
        for text in distill.WHISPER_EVAL_TEXTS:
            ids, transcript = jax_transcribe(eng, distill.render_speech(text))
            records[name].append({"text": text, "transcript": transcript, "token_ids": ids})
    whisper_ckpt.STT_GOLDEN_JSON.write_text(json.dumps({
        "source": "checkpoints/whisper-tiny-{overfit,heldout} through the JAX package's "
                  "SpeechEngine(kernels='pallas') configured as distill.whisper_engine_from "
                  "(interpret mode on the CPU), transcribe(render_speech(text))",
        "checkpoints": records}, indent=1) + "\n")


@pytest.fixture(scope="module", params=whisper_ckpt.CHECKPOINTS)
def both(request):
    name = request.param
    cfg, params, jeng = _jax_engine(name)
    teng = whisper_ckpt.whisper_engine_from(*whisper_ckpt.load_whisper(name, device="cpu"),
                                            device="cpu")
    return name, cfg, params, jeng, teng


def test_eval_texts_and_speech_equal_the_jax_package():
    assert whisper_ckpt.WHISPER_EVAL_TEXTS == distill.WHISPER_EVAL_TEXTS
    for text in ("search for red shoes", "it's 9 o'clock!"):
        np.testing.assert_array_equal(whisper_ckpt.render_speech(text),
                                      distill.render_speech(text))


def test_npz_equals_the_orbax_tree(both):
    name, cfg, params, _, teng = both
    flat = bridge.flatten(jax.tree_util.tree_map(np.asarray, params))
    with np.load(whisper_ckpt.npz_path(name)) as z:
        assert sorted(z.files) == sorted(flat)
        for key, a in flat.items():
            assert z[key].dtype == a.dtype
            np.testing.assert_array_equal(z[key], a)
    meta = json.loads(whisper_ckpt.meta_path(name).read_text())
    assert meta["config"] == dataclasses.asdict(cfg)
    assert teng.cfg.head_dim == 16 and teng.frame_buckets == (cfg.max_audio_frames,)


def test_port_cpu_transcripts_equal_the_recorded_and_jax(both):
    name, _, _, jeng, teng = both
    recs = whisper_ckpt.golden_records()[name]
    assert [r["text"] for r in recs] == distill.WHISPER_EVAL_TEXTS
    for rec in recs:
        audio = distill.render_speech(rec["text"])
        jids, jtext = jax_transcribe(jeng, audio)
        res = teng.transcribe(audio)
        assert res.token_ids == rec["token_ids"] == jids, (name, rec["text"])
        assert res.text == rec["transcript"] == jtext
    if name == "whisper-tiny-overfit":  # trained on these very texts
        assert all(r["transcript"] == r["text"] for r in recs)


if __name__ == "__main__":
    if "--write" not in sys.argv[1:]:
        sys.exit(__doc__)
    write_data()
    print(f"wrote {whisper_ckpt.DATA_DIR}/whisper-tiny-*.npz/.json and "
          f"{whisper_ckpt.STT_GOLDEN_JSON}")
