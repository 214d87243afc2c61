"""Streaming speech-to-text engine on the port's Whisper model.

Port of ``tpu_voice_agent/serve/stt.py`` (the B = 1 per-connection plane):

- audio accumulates host-side; every ``partial_interval_s`` of new speech the
  utterance so far is transcribed and emitted as a partial, incrementally
  (each 0.5 s block encoded once, its cross-KV appended);
- the energy endpointer closes the utterance -> final transcript; once the
  speaker pauses, the final is transcribed speculatively (``spec_final``) and
  a consumer's grammar-complete parse may close the utterance early;
- transcription = mel (matmul STFT) -> encoder (audio-frame buckets, K1) ->
  cross-KV -> greedy decode (K5 on every T = 1 step).

The JAX ``lax.while_loop`` decode is a Python loop here with the same carry
semantics; its ``all(done)`` test reads one bool back from the device per
step. With the quality lanes on (``QUALITY_ENABLE``, default on) the loop
also accumulates the emitted tokens' log-probabilities (sum, min, first) on
the device, read back once with the tokens; ``finalize_stt_ids`` turns them
into the transcript's confidence. The endpoint counters and the process-wide
``stt.feed_lag_s`` / ``stt.buffered_audio_s`` gauges are JAX's. The cost
lanes (``COST_ENABLE``, default on): each encode dispatch and each B = 1
decode loop folds its analytic FLOPs into ``cost_totals`` (the voice
service's ``/debug/costs``) and the ``cost.stt_*_flops`` counters. The
decode loop also serves the batched plane (``serve.stt_batch``): a ``live``
slot mask and a per-slot ``max_new_each`` budget; the replicated tier
(``serve.stt_replicas``) runs several batchers over one engine.
``SpeechEngine.from_hf`` serves an HF Whisper directory: its tokenizer, the
``<|startoftranscript|>`` prompt, and every control token but EOS suppressed
in both planes' decode loop.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..audio.endpoint import EnergyEndpointer
from ..audio.mel import MelConfig, log_mel_spectrogram
from ..grammar.intent_grammar import default_tokenizer
from ..models.whisper import (
    PRESETS,
    WhisperConfig,
    compute_cross_kv,
    decoder_forward,
    encoder_forward,
    init_params,
    init_self_cache,
    with_unstacked_layers,
)
from ..utils.chaos import chaos_fire
from ..utils.compilewatch import watch_compiles
from ..utils.costmodel import (
    cost_enabled,
    register_stt_engine,
    whisper_decoder_flops,
    whisper_encoder_flops,
)
from ..utils.quality import quality_lanes_enabled, repetition_score
from ..utils.tracing import get_metrics
from .engine import _sync, resolve_device


@watch_compiles("stt._stt_decode_loop")
@torch.no_grad()
def _stt_decode_loop(params, cfg: WhisperConfig, self_cache: dict, cross_kv: dict,
                     enc_len: torch.Tensor, bos: torch.Tensor, max_new: int = 64,
                     eos_id: int = 2, pad_id: int = 0, quality_lanes: bool = False,
                     live: torch.Tensor | None = None,
                     max_new_each: torch.Tensor | None = None, fence=None,
                     suppress: torch.Tensor | None = None):
    """Greedy decode until EOS. ``bos`` (B, P) is the decoder prompt
    (``<|startoftranscript|><|lang|><|transcribe|><|notimestamps|>`` for a
    checkpoint); ``suppress`` (V,) bool, when given, masks the ids every
    pick must skip (a checkpoint's control tokens, EOS excepted). Every
    row stops on its own EOS, at ``max_text_len - 1``, or after its budget
    (``max_new``, or the row's entry of ``max_new_each`` (B,) int32), and
    the loop runs until all rows are done. The ONE loop of the B = 1 paths
    and the batched plane (``serve.stt_batch``), which passes ``live`` (B,)
    bool: a dead slot is done from the start (its cross-KV rows hold
    garbage, and its ``enc_len`` is 0, so its attention reads nothing).
    With ``live`` / ``max_new_each`` None the loop is the single-stream one.
    ``fence``, when given, is called before each decoder forward and may
    raise to stop the loop (a killed batcher's worker).
    With ``quality_lanes``
    each emitted token's log-probability (an fp32 log-softmax of its step's
    logits; the first from the prompt step) folds into per-row (sum, min,
    first) lanes; EOS is not emitted and not counted. The lanes only read:
    the argmax is the same. Returns ``(out (B, max_new) int32 padded with
    pad_id, n (B,) emitted counts, self_cache, conf)``: conf is the three
    lanes, or None with the lanes off."""
    B, P = bos.shape
    dev = bos.device

    def pick(lg):
        if suppress is not None:
            lg = torch.where(suppress[None, :], float("-inf"), lg)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        if not quality_lanes:
            return tok, None
        lsm = torch.log_softmax(lg.float(), dim=-1)
        return tok, torch.gather(lsm, 1, tok[:, None].long())[:, 0]

    fence = fence or (lambda: None)
    pos0 = torch.arange(P, dtype=torch.int32, device=dev)[None, :].expand(B, P)
    fence()
    logits, self_cache = decoder_forward(params, cfg, bos, pos0, self_cache, cross_kv, enc_len)
    cur, cur_lp = pick(logits[:, P - 1, :])
    conf = None
    if quality_lanes:
        conf = (torch.zeros((B,), dtype=torch.float32, device=dev),  # logprob sum
                torch.full((B,), float("inf"), dtype=torch.float32, device=dev),  # min
                torch.zeros((B,), dtype=torch.float32, device=dev))  # first emitted
    budget = (torch.full((B,), max_new, dtype=torch.int32, device=dev) if max_new_each is None
              else max_new_each.to(torch.int32))
    done = (cur == eos_id) | (budget <= 0)
    if live is not None:
        done = done | ~live
    out = torch.full((B, max_new), pad_id, dtype=torch.int32, device=dev)
    pos = torch.full((B,), P, dtype=torch.int32, device=dev)
    n = torch.zeros((B,), dtype=torch.int32, device=dev)
    ar = torch.arange(B, device=dev)
    step = 0
    while step < max_new and not bool(done.all()):  # one host sync per step
        live = ~done
        idx = torch.clamp(n, max=max_new - 1).long()
        out[ar, idx] = torch.where(live, cur, out[ar, idx])
        if conf is not None:
            conf = (conf[0] + torch.where(live, cur_lp, 0.0),
                    torch.where(live, torch.minimum(conf[1], cur_lp), conf[1]),
                    torch.where(live & (n == 0), cur_lp, conf[2]))
        n = n + live.to(torch.int32)
        fence()
        logits, self_cache = decoder_forward(params, cfg, cur[:, None], pos[:, None], self_cache,
                                             cross_kv, enc_len)
        nxt, nxt_lp = pick(logits[:, 0, :])
        pos = torch.where(live, pos + 1, pos)
        done = done | (nxt == eos_id) | (pos >= cfg.max_text_len - 1) | (n >= budget)
        cur = torch.where(live, nxt, cur)
        if conf is not None:
            cur_lp = torch.where(live, nxt_lp, cur_lp)
        step += 1
    return out, n, self_cache, conf


def finalize_stt_ids(ids: list[int], conf_row, quality_lanes: bool, final: bool = False):
    """THE post-decode tail: on a ``final`` the ``stt_garble`` chaos collapse
    (the ids become their first token repeated; the latency stays green),
    then one row's lanes ``(sum, min, first)`` -> the transcript's
    ``logp_mean`` / ``logp_min`` / ``logp_first`` (None with the lanes off
    or nothing emitted), and the repetition score over the ids. Returns
    ``(ids, logp_mean, logp_min, logp_first, repetition)``."""
    if final and ids and chaos_fire("stt_garble"):
        ids = [ids[0]] * len(ids)
    logp_mean = logp_min = logp_first = None
    if quality_lanes and ids:
        lp_sum, lp_min, lp_first = (float(x) for x in conf_row)
        logp_mean = round(lp_sum / len(ids), 4)
        logp_min = round(lp_min, 4) if lp_min != float("inf") else None
        logp_first = round(lp_first, 4)
    rep = round(repetition_score(ids), 4) if ids else None
    return ids, logp_mean, logp_min, logp_first, rep


@dataclass
class TranscribeResult:
    text: str
    encode_ms: float
    decode_ms: float
    n_frames: int
    token_ids: list[int] = field(default_factory=list)
    forwards: int = 0  # decoder forwards (prompt step included)
    # the confidence lanes (None with the lanes off or no token emitted):
    # per-token logprob mean / min, the first token's logprob, and the
    # host-side repetition score over the emitted ids
    logp_mean: float | None = None
    logp_min: float | None = None
    logp_first: float | None = None
    repetition: float | None = None


@watch_compiles("stt._append_cross_kv")
def _append_cross_kv(buf_k: torch.Tensor, buf_v: torch.Tensor, new_k: torch.Tensor,
                     new_v: torch.Tensor, offset: int, slot: int = 0) -> None:
    """Write one encoded block's cross-KV (L, 1, keep, nh, hd) into an
    (L, S, positions, nh, hd) buffer at encoder frame ``offset`` of batch
    row ``slot``, in place: row 0 of a per-connection buffer, or a pool slot
    of the batched plane (``serve.stt_batch``)."""
    keep = new_k.shape[2]
    buf_k[:, slot:slot + 1, offset:offset + keep] = new_k
    buf_v[:, slot:slot + 1, offset:offset + keep] = new_v


@dataclass
class IncrementalState:
    """Streaming encoder state: the utterance's accumulated cross-attention
    KV plus host-side frame accounting. Each ~0.5 s block is encoded once
    (block-local attention at its true positions) and its cross-KV is
    written into the buffer in place; finals still re-encode the whole
    window."""

    cross_k: torch.Tensor  # (L, 1, enc_positions, nh, hd)
    cross_v: torch.Tensor
    enc_len: int = 0  # valid encoder frames
    consumed_frames: int = 0  # mel frames consumed from the utterance buffer
    anchor_frames: int = 0  # buffer frame treated as utterance position 0


class SpeechEngine:
    """Whisper encoder-decoder with audio-length buckets, on one device."""

    # mel frames per incremental encode block (0.5 s) and the re-encoded
    # left context carried for conv/attention continuity at block joins
    INC_STEP = 50
    INC_LOOKBACK = 20

    def __init__(
        self,
        preset: str = "whisper-test",
        cfg: WhisperConfig | None = None,
        seed: int = 0,
        frame_buckets: tuple[int, ...] = (100, 300, 1000, 3000),
        max_new_tokens: int = 64,
        mel_cfg: MelConfig = MelConfig(),
        kernels: str = "auto",  # "auto" | "kernels"
        init_weights: bool = True,  # False: the caller loads weights next
        device: str | torch.device | None = None,  # None = cuda, or raise
        tokenizer=None,  # a checkpoint tokenizer; None = the in-tree one
        bos_ids: tuple[int, ...] | None = None,  # the decoder prompt (sot sequence)
    ):
        self.device = resolve_device(device)
        self.quality_lanes = quality_lanes_enabled()  # read at each decode
        # "auto" and "kernels" both take K1 / K5: the wrappers launch the
        # CUDA kernels on cuda tensors and their plain versions on CPU ones
        if kernels not in ("auto", "kernels"):
            raise ValueError(f"unknown kernels {kernels!r}")
        base = cfg or PRESETS[preset]
        if tokenizer is None:
            self.tokenizer = default_tokenizer()
            vocab = self.tokenizer.vocab_size
        else:
            self.tokenizer = tokenizer
            vocab = base.vocab_size if cfg is not None else tokenizer.vocab_size
            if vocab < tokenizer.vocab_size:
                raise ValueError(
                    f"model vocab {vocab} < tokenizer vocab {tokenizer.vocab_size}")
        self.cfg = replace(base, vocab_size=vocab)
        self.eos_id = int(self.tokenizer.eos_id)
        self.pad_id = int(self.tokenizer.pad_id)
        self.bos_ids = tuple(bos_ids) if bos_ids else (int(self.tokenizer.bos_id),)
        # greedy decode never emits a special (a Whisper vocabulary carries
        # hundreds of <|...|> control tokens); EOS stays pickable
        special = getattr(self.tokenizer, "special_ids", None)
        self.suppress = None
        if special:
            sup = torch.zeros(vocab, dtype=torch.bool)
            sup[sorted(special)] = True
            sup[self.eos_id] = False
            self.suppress = sup.to(self.device)
        # the mel front end feeds what the encoder expects (large-v3 uses
        # 128 bins, the rest of the family 80)
        self.mel_cfg = replace(mel_cfg, n_mels=self.cfg.n_mels)
        self.frame_buckets = tuple(b for b in frame_buckets if b <= self.cfg.max_audio_frames)
        if not self.frame_buckets:
            raise ValueError(
                f"no frame bucket in {frame_buckets} fits this config's "
                f"max_audio_frames ({self.cfg.max_audio_frames})")
        self.max_new_tokens = max_new_tokens
        # the STT share of the cost meter: analytic encoder / decoder FLOPs
        # per encode dispatch and decode loop, host ints only
        self.cost_lanes = cost_enabled()
        self.cost_totals = {"encoder_flops": 0, "decoder_flops": 0, "encoded_frames": 0,
                            "decoded_tokens": 0}
        if self.cost_lanes:
            register_stt_engine(self)
        self.params = None
        if init_weights:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.load_params(init_params(self.cfg, gen, device=self.device))

    def load_params(self, params: dict) -> None:
        """Install weights (the stacked param tree on this engine's
        device); the layers are kept as per-layer views."""
        self.params = with_unstacked_layers(params)

    @classmethod
    def from_hf(cls, model_dir: str, language: str = "en", dtype=torch.bfloat16,
                device: str | torch.device | None = None, **kw) -> "SpeechEngine":
        """Serve an HF Whisper checkpoint directory (``config.json``,
        ``tokenizer.json``, ``*.safetensors``). The decoder prompt is the
        checkpoint's ``<|startoftranscript|><|lang|><|transcribe|>
        <|notimestamps|>`` (the ids it has), and every control token but EOS
        is suppressed in greedy decode."""
        from ..ckpt.hf_import import whisper_config_from_hf, whisper_from_hf_state
        from ..grammar.hf_tokenizer import load_hf_tokenizer

        cfg = whisper_config_from_hf(model_dir)
        tok = load_hf_tokenizer(model_dir)
        bos = [tok.id_of(name) for name in ("<|startoftranscript|>", f"<|{language}|>",
                                            "<|transcribe|>", "<|notimestamps|>")]
        bos = tuple(t for t in bos if t is not None)
        eng = cls(cfg=cfg, tokenizer=tok, bos_ids=bos or None, init_weights=False,
                  device=device, **kw)
        eng.load_params(whisper_from_hf_state(model_dir, cfg, dtype=dtype, device=eng.device))
        return eng

    @property
    def _param_dtype(self):
        """Cache/state dtype: follow the params (fp32-trained checkpoints
        keep fp32 K/V; bf16 weights keep the cheap cache)."""
        return self.params["decoder"]["tok_emb"].dtype if self.params else torch.bfloat16

    def _bucket(self, n_frames: int) -> int:
        for b in self.frame_buckets:
            if n_frames <= b:
                return b
        return self.frame_buckets[-1]

    def _fold_encoder_cost(self, n_frames: int) -> None:
        """One encode dispatch over ``n_frames`` mel frames (an incremental
        block pays its lookback re-encode too)."""
        if not self.cost_lanes:
            return
        fl = whisper_encoder_flops(self.cfg, n_frames)
        self.cost_totals["encoder_flops"] += fl
        self.cost_totals["encoded_frames"] += int(n_frames)
        get_metrics().inc("cost.stt_encoder_flops", float(fl))

    def _fold_decoder_cost(self, n_tokens: int, enc_len: int) -> None:
        """One greedy decode loop: ``n_tokens`` forwards (emitted + the
        prompt) cross-attending ``enc_len`` encoder positions."""
        if not self.cost_lanes:
            return
        fl = whisper_decoder_flops(self.cfg, n_tokens, enc_len)
        self.cost_totals["decoder_flops"] += fl
        self.cost_totals["decoded_tokens"] += int(n_tokens)
        get_metrics().inc("cost.stt_decoder_flops", float(fl))

    def _mel(self, audio: np.ndarray) -> torch.Tensor:
        return log_mel_spectrogram(torch.from_numpy(np.ascontiguousarray(audio, np.float32))
                                   .to(self.device), self.mel_cfg)

    # ------------------------------------------------------ incremental

    def anchor_for(self, total_frames: int) -> int:
        """The (even) buffer frame streaming consumption anchors at: at most
        one window back, so retained pre-speech silence cannot spend the
        cross-KV budget."""
        return max(0, total_frames - self.cfg.enc_positions) & ~1

    def incremental_init(self, total_frames: int = 0) -> IncrementalState:
        """Fresh streaming state; ``total_frames`` = mel frames already in
        the utterance buffer."""
        L, nh, hd = self.cfg.dec_layers, self.cfg.n_heads, self.cfg.head_dim
        shape = (L, 1, self.cfg.enc_positions, nh, hd)
        anchor = self.anchor_for(total_frames)
        return IncrementalState(
            cross_k=torch.zeros(shape, dtype=self._param_dtype, device=self.device),
            cross_v=torch.zeros(shape, dtype=self._param_dtype, device=self.device),
            consumed_frames=anchor, anchor_frames=anchor)

    def _encode_block(self, buf: np.ndarray, anchor_frames: int, consumed_frames: int):
        """Encode ONE INC_STEP block of ``buf`` at its true utterance offset
        (re-encoding INC_LOOKBACK frames of left context, dropped from the
        output). Returns ``(new_k, new_v, keep)``: the (L, 1, keep, nh, hd)
        cross-KV slab to append."""
        hop = self.mel_cfg.hop
        step, lb = self.INC_STEP, self.INC_LOOKBACK
        c = consumed_frames
        start = max(anchor_frames, c - lb)
        n_window = c + step - start  # 50 (anchor block) or 70
        mel = self._mel(buf[start * hop:(c + step) * hop])[None, :n_window]
        enc = encoder_forward(self.params, self.cfg, mel, pos_offset=(start - anchor_frames) // 2)
        kv = compute_cross_kv(self.params, self.cfg, enc)
        drop = (c - start) // 2  # lookback outputs: context only
        keep = step // 2
        self._fold_encoder_cost(n_window)
        return kv["k"][:, :, drop:drop + keep], kv["v"][:, :, drop:drop + keep], keep

    def incremental_feed(self, state: IncrementalState, buf: np.ndarray) -> IncrementalState:
        """Encode any complete new INC_STEP blocks of ``buf`` (the utterance
        audio so far) into the state's cross-KV, in place. When an utterance
        outgrows the cross-KV budget the state re-anchors on the most recent
        window."""
        hop = self.mel_cfg.hop
        step = self.INC_STEP
        total = len(buf) // hop
        while total - state.consumed_frames >= step:
            if state.enc_len + step // 2 > self.cfg.enc_positions:
                state = self.incremental_init(total)
                continue
            c = state.consumed_frames
            new_k, new_v, keep = self._encode_block(buf, state.anchor_frames, c)
            e = state.enc_len
            _append_cross_kv(state.cross_k, state.cross_v, new_k, new_v, e)
            state = IncrementalState(cross_k=state.cross_k, cross_v=state.cross_v,
                                     enc_len=e + keep, consumed_frames=c + step,
                                     anchor_frames=state.anchor_frames)
        return state

    def incremental_decode(self, state: IncrementalState) -> TranscribeResult:
        """Greedy decode over the accumulated cross-KV. encode_ms is 0: the
        encode cost was paid incrementally in feed()."""
        return self._decode({"k": state.cross_k, "v": state.cross_v}, state.enc_len,
                            state.consumed_frames)

    # ------------------------------------------------------ transcribe

    def _decode(self, cross_kv: dict, enc_len: int, n_frames: int,
                final: bool = False) -> TranscribeResult:
        """Shared decode tail of transcribe() and the streaming partials:
        greedy loop over the cross-KV at its own length -> transcript.
        ``final`` (transcribe) arms ``stt_garble`` in ``finalize_stt_ids``."""
        t0 = time.perf_counter()
        cache = init_self_cache(self.cfg, 1, dtype=self._param_dtype, device=self.device)
        bos = torch.tensor([list(self.bos_ids)], dtype=torch.int32, device=self.device)
        lens = torch.tensor([enc_len], dtype=torch.int32, device=self.device)
        out, n, _, conf = _stt_decode_loop(self.params, self.cfg, cache, cross_kv, lens, bos,
                                           max_new=self.max_new_tokens, eos_id=self.eos_id,
                                           pad_id=self.pad_id, quality_lanes=self.quality_lanes,
                                           suppress=self.suppress)
        # one readback: the tokens, the count and the lanes (token ids and
        # counts are exact in float32)
        cols = [out[0].float(), n.float()] + ([c.float() for c in conf] if conf else [])
        h = torch.cat(cols).cpu().numpy()
        W = out.shape[1]
        n_h = int(h[W])
        ids = [int(t) for t in h[:n_h]]
        decode_ms = (time.perf_counter() - t0) * 1e3
        self._fold_decoder_cost(n_h + len(self.bos_ids), max(1, int(n_frames) // 2))
        ids, logp_mean, logp_min, logp_first, rep = finalize_stt_ids(
            ids, h[W + 1:W + 4], self.quality_lanes, final)
        return TranscribeResult(text=self.tokenizer.decode(ids).strip(), encode_ms=0.0,
                                decode_ms=decode_ms, n_frames=n_frames, token_ids=ids,
                                forwards=1 + min(n_h, self.max_new_tokens),
                                logp_mean=logp_mean, logp_min=logp_min,
                                logp_first=logp_first, repetition=rep)

    def _encode_window(self, audio: np.ndarray):
        """Front half of transcribe(): bucket, pad, mel, encode, cross-KV.
        Returns ``(cross_kv, enc_len, n_frames)``."""
        hop = self.mel_cfg.hop
        n_frames = max(1, len(audio) // hop)
        bucket = self._bucket(n_frames)
        want = bucket * hop
        if len(audio) > want:
            audio = audio[-want:]
            n_frames = bucket
        padded = np.zeros(want, dtype=np.float32)
        padded[: len(audio)] = audio
        mel = self._mel(padded)[None, :bucket]
        enc_out = encoder_forward(self.params, self.cfg, mel)
        cross_kv = compute_cross_kv(self.params, self.cfg, enc_out)
        self._fold_encoder_cost(bucket)
        return cross_kv, max(1, n_frames // 2), n_frames

    def transcribe(self, audio: np.ndarray) -> TranscribeResult:
        """audio: float32 mono 16 kHz. Longer than the top bucket -> keep the
        most recent window (streaming semantics). encode_ms runs to the
        encoder's completion on the device."""
        t0 = time.perf_counter()
        cross_kv, enc_len, n_frames = self._encode_window(audio)
        _sync(self.device)
        encode_ms = (time.perf_counter() - t0) * 1e3
        res = self._decode(cross_kv, enc_len, n_frames, final=True)
        return dataclasses.replace(res, encode_ms=encode_ms)


# process-wide saturation aggregate: every live StreamingSTT deposits its
# (feed_lag_s, buffered_audio_s) and the gauges export the max lag and the
# summed buffered seconds across streams; a closed connection's entry goes
# with its STT object (weak keys)
_AGG_LOCK = threading.Lock()
_LIVE_STREAMS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _record_stream_gauges(inst, feed_lag_s: float, buffered_s: float) -> None:
    m = get_metrics()
    with _AGG_LOCK:
        _LIVE_STREAMS[inst] = (feed_lag_s, buffered_s)
        vals = list(_LIVE_STREAMS.values())
        m.set_gauge("stt.feed_lag_s", round(max(v[0] for v in vals), 4))
        m.set_gauge("stt.buffered_audio_s", round(sum(v[1] for v in vals), 4))


class StreamingSTT:
    """Utterance-windowed streaming wrapper: feed PCM, get partial/final events.

    Events: ("partial", text) while speech continues; ("spec_final", text)
    when the speaker has paused long enough that the utterance is plausibly
    over (the speculative full-window transcription); ("final", text) when
    the endpointer closes the utterance.

    Adaptive early endpoint: when the consumer reports via
    ``parse_complete(text)`` that the speculative parse of the CURRENT
    speculative transcript finished grammar-complete, and the transcript
    has stayed stable (zero new speech frames) through ``early_close_ms`` of
    trailing silence, the utterance closes early instead of waiting out the
    full window. ``early_closes`` / ``window_closes`` count the two.
    ``feed_lag_s`` is the cumulative processing deficit: feed() wall time in
    excess of the audio it consumed (> 0 = behind real time).
    """

    def __init__(
        self,
        engine: SpeechEngine,
        partial_interval_s: float = 0.5,
        endpointer: EnergyEndpointer | None = None,
        early_close_ms: float | None = 240.0,
    ):
        self.engine = engine
        self.partial_interval_s = partial_interval_s
        self.endpointer = endpointer or EnergyEndpointer(sample_rate=engine.mel_cfg.sample_rate)
        # None disables early close; the default is armed but inert until a
        # consumer calls parse_complete
        self.early_close_ms = early_close_ms
        self.early_closes = 0
        self.window_closes = 0
        self._inc: IncrementalState | None = None
        self._spec_final: TranscribeResult | None = None
        self._spec_at_speech = -1  # endpointer.total_speech_frames at spec time
        self._parse_done: str | None = None
        self.last_final: TranscribeResult | None = None
        self._buf = np.zeros(0, dtype=np.float32)
        self._since_partial = 0.0
        self.feed_lag_s = 0.0

    def reset(self) -> None:
        self._buf = np.zeros(0, dtype=np.float32)
        self._since_partial = 0.0
        self._inc = None
        self._spec_final = None
        self._spec_at_speech = -1
        self._parse_done = None
        self.feed_lag_s = 0.0
        self.endpointer.reset()

    @property
    def buffered_samples(self) -> int:
        """Samples of the open utterance (0 right after a close)."""
        return len(self._buf)

    def parse_complete(self, text: str) -> None:
        """Consumer signal: the speculative parse of ``text`` finished and
        was grammar-complete. May be called from another thread: a single
        attribute store is atomic under the GIL, and feed() re-validates it
        against the current speculative transcript before acting."""
        self._parse_done = text

    # -------------------------------------------------- transcription hooks
    # (the JAX package's batched plane overrides these four; here they are
    # the inline engine calls)

    def _start_speculation(self, spoken: int, events: list) -> None:
        """The speaker paused: transcribe the (content-frozen) buffer now so
        the endpoint confirmation only delivers it."""
        self._spec_final = self.engine.transcribe(self._buf)
        self._spec_at_speech = spoken
        if self._spec_final.text:
            events.append(("spec_final", self._spec_final.text))

    def _final_result(self, fresh: bool, spoken: int) -> TranscribeResult | None:
        """The endpoint closed: the exact full-window transcription (the
        fresh speculation when the pause was long enough to have seen one)."""
        return self._spec_final if fresh else self.engine.transcribe(self._buf)

    def _emit_partial(self, events: list) -> None:
        """Mid-speech partial tick: encode the new blocks of the utterance
        and decode over everything encoded so far."""
        if self._inc is None:
            self._inc = self.engine.incremental_init(len(self._buf) // self.engine.mel_cfg.hop)
        self._inc = self.engine.incremental_feed(self._inc, self._buf)
        if self._inc.enc_len > 0:
            res = self.engine.incremental_decode(self._inc)
            if res.text:
                events.append(("partial", res.text))

    def _drain_ready(self, events: list) -> None:
        """Deliver transcriptions completed since the last feed (async
        planes only; the inline base has none)."""

    def _utterance_closed(self) -> None:
        """Per-utterance server-side state can be released."""

    def feed(self, samples: np.ndarray) -> list[tuple[str, str]]:
        t_feed0 = time.perf_counter()
        sr = self.engine.mel_cfg.sample_rate
        events: list[tuple[str, str]] = []
        self._drain_ready(events)
        ended = self.endpointer.feed(samples)
        self._buf = np.concatenate([self._buf, samples.astype(np.float32)])
        self._since_partial += len(samples) / sr

        # bound the buffer: outside speech only the top transcription window
        # matters; the trim invalidates incremental frame accounting
        max_samples = self.engine.frame_buckets[-1] * self.engine.mel_cfg.hop
        if not self.endpointer.in_speech and len(self._buf) > max_samples:
            self._buf = self._buf[-max_samples:]
            self._inc = None

        # speculative final: once the speaker pauses, the content is frozen;
        # staleness keys on the endpointer's monotone speech-frame counter
        spoken = self.endpointer.total_speech_frames
        if (not ended and self.endpointer.in_trailing_silence
                and self._spec_at_speech != spoken):
            self._start_speculation(spoken, events)

        # adaptive early endpoint, re-validated here against current state
        fresh = self._spec_final is not None and self._spec_at_speech == spoken
        if (not ended and fresh and self._spec_final.text
                and self._parse_done == self._spec_final.text
                and self.early_close_ms is not None
                and self.endpointer.silence_run_ms >= self.early_close_ms
                and self.endpointer.force_end()):
            ended = True
            self.early_closes += 1
            get_metrics().inc("stt.endpoint_early_close")
        elif ended:
            self.window_closes += 1
            get_metrics().inc("stt.endpoint_window_close")

        if ended:
            res = self._final_result(fresh, spoken)
            if res is not None:
                self.last_final = res
            if res is not None and res.text:
                events.append(("final", res.text))
            self._buf = np.zeros(0, dtype=np.float32)
            self._since_partial = 0.0
            self._inc = None
            self._spec_final = None
            self._spec_at_speech = -1
            self._parse_done = None
            self._utterance_closed()
        elif (self.endpointer.in_speech and not self.endpointer.in_trailing_silence
              and self._since_partial >= self.partial_interval_s):
            # no partials once the speaker pauses: the speculation covers it
            self._since_partial = 0.0
            self._emit_partial(events)

        self.feed_lag_s = max(
            0.0, self.feed_lag_s + (time.perf_counter() - t_feed0) - len(samples) / sr)
        _record_stream_gauges(self, self.feed_lag_s, len(self._buf) / sr)
        return events


class NullSTT:
    """Offline stand-in (the null-key passthrough): scripted transcripts for
    tests."""

    def __init__(self, scripted: list[tuple[str, str]] | None = None):
        self.scripted = list(scripted or [])
        self.fed_samples = 0
        self.fail_next = False  # fault injection

    def reset(self) -> None:
        self.fed_samples = 0

    def feed(self, samples: np.ndarray) -> list[tuple[str, str]]:
        if self.fail_next:
            self.fail_next = False
            raise RuntimeError("injected STT fault")
        self.fed_samples += len(samples)
        if self.scripted:
            return [self.scripted.pop(0)]
        return []
