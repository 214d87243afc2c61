"""Warm-state handoff: ship a session's warm serving state to another brain.

Port of ``tpu_voice_agent/serve/handoff.py``; its wires are JAX's, byte for
byte, so a blob packed by either package unpacks in the other.

What travels, per session:

- the transcript token ids (``SessionTranscripts``): without them the new
  home renders a turn-1 prompt and the session loses its context;
- the radix chain's paged KV blocks past the pinned static prefix, gathered
  from the donor's pool in the stored format (``gather_chain_kv``): bf16
  values, or under ``KV_QUANT`` the int8 / packed int4 bytes with their bf16
  scale planes. The recipient installs them verbatim (``adopt_chain_kv``)
  and inserts the chain into its own tree behind its own pinned prefix.

Adoption is clean or cold: a mismatch (block size, KV tier, model dims, a
different static prefix), a pool under pressure or a tree at capacity adopts
the transcript alone and returns 0 warm tokens, counted in
``handoff.adopt_fallbacks``; the next turn cold-prefills and decodes the
tokens it would have at home. ``HANDOFF_KV=0`` ships the transcript without
KV (the cold re-home baseline).

Wire (``pack`` / ``unpack``, ``TVAH1``): a magic, a 4-byte header length,
one JSON header (meta and array specs: name, numpy dtype name, shape, byte
count), then the raw array bytes. bf16 tensors travel as their raw 2-byte
words under the dtype name ``bfloat16`` (numpy has no bf16) and unpack
through ``uint16`` viewed as ``torch.bfloat16``, never through float32.
``unpack`` returns CPU tensors.

Frames (``TVAF1``): ``frame_pack`` wraps a payload with a sequence number, a
FINAL flag and its CRC32; ``frame_feed`` parses complete frames off the
front of a buffer and keeps a partial tail (a torn tail is no error); bad
magic or CRC raises ``ValueError``, and ``deframe`` also raises on a torn
tail, a reorder or a misplaced FINAL. ``pack_kv_segment`` and
``StreamAdopter`` are the two ends of the disagg KV stream.

Thread contract: everything that touches an engine (export, adopt, the
stream's segments) runs on the serving-loop thread: ``BatchedEngineParser``
routes it through ``ServingLoop.submit_call``.
"""

from __future__ import annotations

import json
import os
import struct
import warnings
import zlib

import numpy as np
import torch

from ..utils.tracing import get_metrics

MAGIC = b"TVAH1\x00"

# frame wire: magic + (seq, payload bytes, flags, crc32(payload)) + payload;
# FINAL marks the last frame of a stream
FRAME_MAGIC = b"TVAF1\x00"
_FRAME_HDR = struct.Struct(">IIBI")
FRAME_FINAL = 0x01

# the tensor dtypes a blob carries (the pools' values and scales), by their
# numpy names on the wire
_WIRE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.int8: "int8",
               torch.uint8: "uint8", torch.int32: "int32"}


def _raw(arr) -> tuple[str, list[int], bytes]:
    """(wire dtype name, shape, raw bytes) of a tensor or a numpy array."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = _WIRE_NAMES.get(t.dtype)
        if name is None:
            raise ValueError(f"no wire dtype for {t.dtype}")
        words = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return name, list(t.shape), words.numpy().tobytes()
    a = np.ascontiguousarray(arr)
    return a.dtype.name, list(a.shape), a.tobytes()


def pack(meta: dict, arrays: dict) -> bytes:
    """meta (JSON-able) + named tensors / arrays -> one self-describing blob."""
    specs, bufs = [], []
    for name, arr in arrays.items():
        dtype, shape, raw = _raw(arr)
        specs.append({"name": name, "dtype": dtype, "shape": shape, "nbytes": len(raw)})
        bufs.append(raw)
    header = json.dumps({"meta": meta, "arrays": specs}, separators=(",", ":")).encode()
    return b"".join([MAGIC, struct.pack(">I", len(header)), header] + bufs)


def _tensor(buf: memoryview, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.frombuffer(buf, dtype=np.uint16)
        with warnings.catch_warnings():  # read-only bytes: nothing writes them
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(words).view(torch.bfloat16).reshape(shape)
    try:
        a = np.frombuffer(buf, dtype=np.dtype(dtype))
    except TypeError as e:
        raise ValueError(f"handoff array dtype {dtype!r} is unknown") from e
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a).reshape(shape)


def unpack(blob: bytes) -> tuple[dict, dict[str, torch.Tensor]]:
    """Inverse of ``pack``: (meta, CPU tensors). Raises ``ValueError`` on
    anything malformed, which the adopters map to the cold fallback."""
    if not blob.startswith(MAGIC) or len(blob) < len(MAGIC) + 4:
        raise ValueError("not a handoff blob (bad magic)")
    view = memoryview(blob)
    off = len(MAGIC)
    (hlen,) = struct.unpack(">I", blob[off:off + 4])
    off += 4
    try:
        header = json.loads(blob[off:off + hlen])
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"handoff header does not parse: {e}") from e
    off += hlen
    arrays: dict[str, torch.Tensor] = {}
    try:
        for spec in header.get("arrays", []):
            n = int(spec["nbytes"])
            if n < 0 or len(blob) - off < n:
                raise ValueError("handoff blob truncated")
            arrays[spec["name"]] = _tensor(view[off:off + n], spec["dtype"], spec["shape"])
            off += n
        meta = header.get("meta", {})
    except (KeyError, TypeError, AttributeError, RuntimeError) as e:
        # a spec without its keys, or a shape that disagrees with its bytes
        raise ValueError(f"handoff array specs malformed: {e}") from e
    return meta, arrays


# ------------------------------------------------------------------ export


def export_session(engine, transcripts, session_id: str) -> bytes | None:
    """Serialize one session's warm state from ``engine`` (a radix-bearing
    ``PagedDecodeEngine``) and ``transcripts``. None for an unknown
    session. Serving-loop thread only."""
    ids = transcripts.peek(session_id)
    if not ids:
        return None
    radix = getattr(engine, "radix", None)
    meta = {"v": 1, "session_id": session_id, "ids": [int(t) for t in ids],
            "chain_tokens": 0, "prefix_tokens": 0,
            "block_size": getattr(engine, "block_size", 0),
            "kv_quant": getattr(engine, "kv_quant", None) or "off"}
    arrays: dict = {}
    if radix is not None and os.environ.get("HANDOFF_KV", "1") != "0":
        bs = engine.block_size
        chain, matched = radix.match(ids)
        pb = engine._prefix_blocks
        try:
            if matched > len(pb) * bs and chain[:len(pb)] == pb:
                # a session chain past the pinned prefix: ship the blocks
                # after it; the recipient's own root covers the prefix span
                k, v, ks, vs = engine.gather_chain_kv(chain[len(pb):])
                meta["chain_tokens"] = matched
                meta["prefix_tokens"] = len(pb) * bs
                arrays = {"k": k, "v": v}
                if ks is not None:
                    arrays["k_scale"] = ks
                    arrays["v_scale"] = vs
        finally:
            engine.allocator.free(chain)  # the match's refs
    get_metrics().inc("handoff.sessions_exported")
    return pack(meta, arrays)


# ------------------------------------------------------------------- adopt


def _compatible(engine, meta: dict, arrays: dict, ids: list[int]) -> bool:
    """The checks every adoption makes before it installs a byte: the
    shipped KV has this pool's block size, tier and dims, and extends this
    engine's own static prefix."""
    bs = engine.block_size
    pb = engine._prefix_blocks
    k, v = arrays.get("k"), arrays.get("v")
    if k is None or v is None or k.dim() != 5 or tuple(v.shape) != tuple(k.shape):
        return False
    expected = [engine.k_pool.shape[0]] + list(engine.k_pool.shape[2:])
    scales_ok = engine.kv_quant is None or (
        "k_scale" in arrays and "v_scale" in arrays
        and tuple(arrays["k_scale"].shape) == tuple(k.shape[:4])
        and tuple(arrays["v_scale"].shape) == tuple(k.shape[:4]))
    return (meta.get("block_size") == bs
            and meta.get("kv_quant") == (engine.kv_quant or "off")
            and [k.shape[0]] + list(k.shape[2:]) == expected
            and k.dtype == engine.k_pool.dtype
            and scales_ok
            and meta.get("prefix_tokens") == len(pb) * bs
            and ids[:len(pb) * bs] == engine.prefix_ids[:len(pb) * bs])


def adopt_session(engine, transcripts, blob: bytes) -> int:
    """Install a shipped session: the transcript always (the next prompt
    must extend what the donor would have rendered), the KV chain when the
    configuration matches and the pool can take it. Returns the warm token
    count (0: the counted cold fallback). Serving-loop thread only."""
    m = get_metrics()
    meta, arrays = unpack(blob)  # a ValueError reaches the caller's fence
    session_id = meta.get("session_id")
    ids = [int(t) for t in meta.get("ids") or []]
    if not session_id or not ids:
        raise ValueError("handoff blob carries no session transcript")
    transcripts.adopt(session_id, ids)
    m.inc("handoff.sessions_adopted")
    radix = getattr(engine, "radix", None)
    chain_tokens = int(meta.get("chain_tokens") or 0)
    if radix is None or chain_tokens <= 0 or "k" not in arrays:
        if chain_tokens > 0 or arrays:
            m.inc("handoff.adopt_fallbacks")
        return 0
    pb = engine._prefix_blocks
    bs = engine.block_size
    if not (_compatible(engine, meta, arrays, ids)
            and chain_tokens == (len(pb) + arrays["k"].shape[1]) * bs
            and chain_tokens <= len(ids)):
        m.inc("handoff.adopt_fallbacks")
        return 0
    try:
        blocks = engine.adopt_chain_kv(arrays["k"], arrays["v"], arrays.get("k_scale"),
                                       arrays.get("v_scale"))
    except Exception:  # noqa: BLE001 - pool pressure or an install fault: cold
        m.inc("handoff.adopt_fallbacks")
        return 0
    # the tree takes its ref per new node, then ours go: a duplicate chain's
    # blocks or those past max_nodes fall straight back to the pool
    radix.insert(ids[:chain_tokens], pb + blocks)
    engine.allocator.free(blocks)
    # trust the tree, not the install: a tree at capacity may have adopted
    # nothing, and a warm answer would then be a lie
    probe, matched = radix.match(ids)
    if probe:
        engine.allocator.free(probe)
    if matched < chain_tokens:
        m.inc("handoff.adopt_fallbacks")
        return 0
    m.inc("handoff.tokens_adopted", float(chain_tokens))
    return chain_tokens


# ------------------------------------------------------------------ frames


def frame_pack(seq: int, payload: bytes, final: bool = False) -> bytes:
    """Wrap one payload in a sequence-numbered, CRC-checked frame."""
    return b"".join([FRAME_MAGIC,
                     _FRAME_HDR.pack(int(seq), len(payload), FRAME_FINAL if final else 0,
                                     zlib.crc32(payload) & 0xFFFFFFFF),
                     payload])


def frame_feed(buf: bytes) -> tuple[list[tuple[int, bytes, bool]], bytes]:
    """Incremental frame parser: (the complete frames as ``(seq, payload,
    final)``, the leftover tail). A partial trailing frame stays in the
    tail; a bad magic or CRC raises ``ValueError``."""
    frames: list[tuple[int, bytes, bool]] = []
    off = 0
    hdr = len(FRAME_MAGIC) + _FRAME_HDR.size
    while len(buf) - off >= hdr:
        if buf[off:off + len(FRAME_MAGIC)] != FRAME_MAGIC:
            raise ValueError("not a handoff frame (bad magic)")
        seq, n, flags, crc = _FRAME_HDR.unpack(buf[off + len(FRAME_MAGIC):off + hdr])
        if len(buf) - off - hdr < n:
            break
        payload = buf[off + hdr:off + hdr + n]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise ValueError(f"handoff frame {seq} fails CRC")
        frames.append((seq, payload, bool(flags & FRAME_FINAL)))
        off += hdr + n
    return frames, buf[off:]


def frame_split(blob: bytes, chunk_bytes: int) -> list[bytes]:
    """One blob -> framed parts; the last carries the FINAL flag."""
    chunk = max(1, int(chunk_bytes))
    parts = [blob[i:i + chunk] for i in range(0, len(blob), chunk)] or [b""]
    return [frame_pack(i, p, final=(i == len(parts) - 1)) for i, p in enumerate(parts)]


def deframe(body: bytes) -> bytes:
    """Reassemble a fully buffered framed body. Raises ``ValueError`` on a
    torn tail, reordered or repeated sequence numbers, or a missing or
    misplaced FINAL: never an install of torn bytes."""
    frames, rest = frame_feed(body)
    if rest:
        raise ValueError("handoff frame stream has a torn tail")
    if not frames:
        raise ValueError("no handoff frames")
    for i, (seq, _, _) in enumerate(frames):
        if seq != i:
            raise ValueError(f"handoff frames out of order (seq {seq} at position {i})")
    if not frames[-1][2] or any(final for _, _, final in frames[:-1]):
        raise ValueError("handoff frame stream FINAL flag misplaced")
    return b"".join(payload for _, payload, _ in frames)


# ------------------------------------------------------- disagg KV stream


def pack_kv_segment(engine, ids: list[int], seg_blocks: list[int], start_block: int,
                    stream_id: str | None = None) -> bytes:
    """Gather and pack one streamed chain segment: ``seg_blocks`` cover chain
    positions ``[start_block, start_block + len(seg_blocks))`` of ``ids``'s
    block chain (the pinned prefix, positions ``[0, prefix blocks)``, never
    travels). Serving-loop thread only."""
    bs = engine.block_size
    k, v, ks, vs = engine.gather_chain_kv(seg_blocks)
    meta = {"v": 1, "kind": "kv_seg", "stream": stream_id, "ids": [int(t) for t in ids],
            "start_block": int(start_block), "prefix_tokens": len(engine._prefix_blocks) * bs,
            "block_size": bs, "kv_quant": getattr(engine, "kv_quant", None) or "off"}
    arrays = {"k": k, "v": v}
    if ks is not None:
        arrays["k_scale"] = ks
        arrays["v_scale"] = vs
    return pack(meta, arrays)


def pack_kv_end(stream_id: str | None, summary: dict) -> bytes:
    """The stream's end marker: an array-less blob with the exporter's
    totals, sent on the FINAL frame (a torn stream differs from a short one)."""
    return pack({"v": 1, "kind": "kv_end", "stream": stream_id, **summary}, {})


class StreamAdopter:
    """Adopt-behind-the-frontier accumulator for one disagg KV stream.

    Each ``feed`` of a ``kv_seg`` blob installs its blocks (``adopt_chain_kv``)
    while the donor still computes; the radix insert happens once, at close,
    over whatever frontier arrived. Every adopted block keeps this adopter's
    ref until close, so eviction mid-stream never frees a block a later
    segment extends. Closing leaks nothing: ``finish`` (a ``kv_end``) and
    ``abandon`` (torn stream, mismatch, shed) both insert the partial chain
    (a shorter warm prefix is still correct cache) and free the refs.
    Serving-loop thread only."""

    def __init__(self, engine):
        self.engine = engine
        self.ids: list[int] | None = None
        self.blocks: list[int] = []
        self.closed = False

    @property
    def tokens(self) -> int:
        """The warm full-block frontier, pinned prefix included."""
        return (len(self.engine._prefix_blocks) + len(self.blocks)) * self.engine.block_size

    def feed(self, blob: bytes) -> dict:
        """Install one stream blob: ``kv_seg`` adopts its blocks behind the
        frontier, ``kv_end`` commits the chain and closes. Raises
        ``ValueError`` on any mismatch after closing itself clean."""
        if self.closed:
            raise ValueError("disagg stream already closed")
        eng = self.engine
        try:
            meta, arrays = unpack(blob)
        except ValueError:
            self.abandon()
            raise
        kind = meta.get("kind")
        if kind == "kv_end":
            return {"ok": True, "adopted_tokens": self.finish(), "final": True}
        bs = eng.block_size
        pb = len(eng._prefix_blocks)
        ids = [int(t) for t in meta.get("ids") or []]
        k = arrays.get("k")
        ok = (kind == "kv_seg" and getattr(eng, "radix", None) is not None
              and k is not None and k.dim() == 5 and k.shape[1] > 0
              and _compatible(eng, meta, arrays, ids)
              # segments extend the frontier contiguously, in order
              and meta.get("start_block") == pb + len(self.blocks)
              and (pb + len(self.blocks) + int(k.shape[1])) * bs < len(ids)
              and (self.ids is None or ids == self.ids))
        if not ok:
            self.abandon()
            raise ValueError("disagg segment incompatible or out of order")
        try:
            newb = eng.adopt_chain_kv(k, arrays["v"], arrays.get("k_scale"),
                                      arrays.get("v_scale"))
        except Exception as e:
            # pool pressure or an install fault: keep what landed, close clean
            self.abandon()
            raise ValueError(f"disagg adopt failed: {type(e).__name__}") from e
        self.ids = ids
        self.blocks.extend(newb)
        get_metrics().inc("disagg.segments_adopted")
        return {"ok": True, "adopted_tokens": self.tokens, "blocks": len(newb),
                "final": False}

    def _close(self) -> int:
        """Insert the arrived frontier, free our refs, and report the warm
        token count the tree confirms. Idempotent."""
        if self.closed:
            return 0
        self.closed = True
        eng = self.engine
        blocks, self.blocks = self.blocks, []
        if not blocks or self.ids is None:
            return 0
        m = get_metrics()
        tokens = (len(eng._prefix_blocks) + len(blocks)) * eng.block_size
        try:
            eng.radix.insert(self.ids[:tokens], eng._prefix_blocks + blocks)
        finally:
            eng.allocator.free(blocks)
        if eng.radix.cached_tokens(self.ids) < tokens:
            m.inc("handoff.adopt_fallbacks")
            return 0
        m.inc("handoff.tokens_adopted", float(tokens))
        return tokens

    def finish(self) -> int:
        """The clean end-of-stream commit. Returns the warm token count."""
        return self._close()

    def abandon(self) -> int:
        """A torn stream, a mismatch or a shed: the partial chain is
        committed best-effort and the refs freed. Always 0: the caller
        treats the stream as fallen back."""
        get_metrics().inc("disagg.streams_aborted")
        self._close()
        return 0
