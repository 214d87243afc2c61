"""The disagg KV stream (``serve/handoff.py`` frames, ``pack_kv_segment``,
``StreamAdopter``; the batcher's ``prefill_export``; the brain's
``/admin/disagg/*`` routes) against the JAX package's.

JAX's ``tests/test_disagg.py`` frame and stream cases run on both packages
over one float32 test-tiny weight tree: the frame wire's bytes, a streamed
chain that leaves the decode side token-identical to a cold control with
both pools balanced, a stream cut mid-way, a tier mismatch and a skipped
segment, each clean or cold with the port's counts equal to JAX's. Then
the routes: the port's prefill brain streams chunked frames while the
prompt computes, each forwarded to a decode brain of either package, and a
``prefill_replica_kill`` drill tears the stream as JAX's does.
"""

import http.client
import json
import threading

import pytest
import torch

from tests.http_helper import AppServer
from tests.torch_warm_helper import Side, jax_weights

PROMPT_TEXT = ("search for wireless noise cancelling headphones under two hundred dollars and "
               "sort the results by customer rating then open the second result and add it to "
               "the cart")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    w = jax_weights()
    return {"jax": Side("jax", w), "port": Side("port", w)}


@pytest.fixture(autouse=True)
def _chaos_hygiene():
    from tpu_voice_agent.utils import chaos as jchaos
    from tpu_voice_agent_torch.utils import chaos as tchaos

    jchaos.reset()
    tchaos.reset()
    yield
    jchaos.reset()
    tchaos.reset()


def _context() -> dict:
    """A fat context payload standing in for a long cold transcript: the
    prompt streams several chunks past the pinned prefix."""
    return {"last_query": "usb c hub", "page": "results",
            "history": [f"step {i}: compared item number {i} against the shortlist and kept "
                        "the cheaper one" for i in range(12)]}


def _prompt(side):
    return side.brain.render_prompt(PROMPT_TEXT, _context())


def _both(sides, case, *a):
    j = case(sides["jax"], *a)
    t = case(sides["port"], *a)
    assert t == j
    return t


# ------------------------------------------------------------- frame wire


def test_frame_roundtrip_incremental_and_torn_tail(sides):
    from tpu_voice_agent_torch.serve import handoff

    payloads = [b"alpha", b"", b"x" * 3000]
    wire = b"".join(handoff.frame_pack(i, p, final=(i == 2)) for i, p in enumerate(payloads))
    jh = sides["jax"].handoff
    assert wire == b"".join(jh.frame_pack(i, p, final=(i == 2)) for i, p in enumerate(payloads))
    buf, got = b"", []
    for i in range(len(wire)):  # byte at a time: frames pop exactly when complete
        buf += wire[i:i + 1]
        frames, buf = handoff.frame_feed(buf)
        got.extend(frames)
    assert buf == b""
    assert [(s, p) for s, p, _ in got] == list(enumerate(payloads))
    assert [f for _, _, f in got] == [False, False, True]
    frames, rest = handoff.frame_feed(wire[:-4])  # a torn tail waits, no frame lost
    assert len(frames) == 2
    assert rest != b"" and wire.endswith(rest + wire[-4:])


def test_frame_corruption_raises():
    from tpu_voice_agent_torch.serve import handoff

    good = handoff.frame_pack(0, b"payload", final=True)
    with pytest.raises(ValueError, match="magic"):
        handoff.frame_feed(b"XXXXXX" + good[6:])
    flipped = bytearray(good)
    flipped[-1] ^= 0xFF  # a corrupt payload byte: the CRC disagrees
    with pytest.raises(ValueError, match="CRC"):
        handoff.frame_feed(bytes(flipped))


def test_deframe_rejects_reorder_truncation_and_bad_final(sides):
    from tpu_voice_agent_torch.serve import handoff

    blob = bytes(range(256)) * 20
    parts = handoff.frame_split(blob, 1000)
    assert parts == sides["jax"].handoff.frame_split(blob, 1000)
    assert len(parts) > 3
    assert handoff.deframe(b"".join(parts)) == blob
    swapped = parts[:]
    swapped[0], swapped[1] = swapped[1], swapped[0]
    with pytest.raises(ValueError, match="out of order"):
        handoff.deframe(b"".join(swapped))
    with pytest.raises(ValueError, match="torn tail"):
        handoff.deframe(b"".join(parts)[:-3])
    with pytest.raises(ValueError, match="FINAL"):
        handoff.deframe(b"".join(parts[:-1]))
    with pytest.raises(ValueError, match="no handoff frames"):
        handoff.deframe(b"")


# --------------------------------------------------------- the KV stream


def _export(side, eng, prompt, stream_blocks, stream_id=None):
    blobs = []
    out = side.batcher(eng, 8).prefill_export(prompt, stream_blocks=stream_blocks,
                                              emit=blobs.append, stream_id=stream_id)
    return out, blobs


def _stream_identity(side):
    pf, dec, control = side.engine(), side.engine(), side.engine()
    prompt = _prompt(side)
    out, blobs = _export(side, pf, prompt, 2, "s1")
    assert out["ok"], out
    assert out["segments"] == len(blobs) >= 2  # chunk-pipelined, not one shot
    assert out["chain_tokens"] > len(pf.prefix_ids)
    side.balanced(pf)  # the exporter committed its own copy, no leak
    ad = side.handoff.StreamAdopter(dec)
    for blob in blobs:
        r = ad.feed(blob)
        assert r["ok"] and not r["final"]
    adopted = ad.feed(side.handoff.pack_kv_end("s1", {"ok": True}))
    assert adopted["final"] and adopted["adopted_tokens"] > 0
    ids = dec.tokenizer.encode(prompt, bos=True)
    assert side.tree(dec).cached_tokens(ids) >= adopted["adopted_tokens"]
    side.balanced(dec)
    moved = side.run(dec, [prompt], 24)[0]
    cold = side.run(control, [prompt], 24)[0]
    assert moved.error is None and cold.error is None
    assert moved.token_ids == cold.token_ids
    assert moved.cached_tokens >= adopted["adopted_tokens"]  # the KV was served
    side.balanced(dec)
    return {k: out[k] for k in ("prompt_tokens", "cached_tokens", "chain_tokens",
                                "segments")}, adopted["adopted_tokens"], moved.token_ids


def test_export_stream_adopt_token_identical(sides):
    _both(sides, _stream_identity)


def _mid_stream_death(side):
    pf, dec, control = side.engine(), side.engine(), side.engine()
    prompt = _prompt(side)
    _, blobs = _export(side, pf, prompt, 1)
    assert len(blobs) >= 2
    before = side.counter("disagg.streams_aborted")
    ad = side.handoff.StreamAdopter(dec)
    ad.feed(blobs[0])  # the first segment lands, then the wire dies
    assert ad.abandon() == 0
    assert side.counter("disagg.streams_aborted") == before + 1
    side.balanced(dec)  # the partial chain is the tree's or freed
    moved = side.run(dec, [prompt], 24)[0]
    cold = side.run(control, [prompt], 24)[0]
    assert moved.token_ids == cold.token_ids
    side.balanced(dec)
    with pytest.raises(ValueError):
        ad.feed(blobs[1])  # a late frame after the kill
    return len(blobs), moved.token_ids, moved.cached_tokens


def test_mid_stream_death_partial_adopt_clean_or_cold(sides):
    _both(sides, _mid_stream_death)


def _tier_mismatch(side):
    pf, dec = side.engine("int8"), side.engine(None)
    prompt = _prompt(side)
    _, blobs = _export(side, pf, prompt, 2)
    assert blobs
    ad = side.handoff.StreamAdopter(dec)
    with pytest.raises(ValueError, match="incompatible"):
        ad.feed(blobs[0])
    assert ad.closed
    side.balanced(dec)
    r = side.run(dec, [prompt], 16)[0]
    assert r.error is None
    return r.token_ids


def test_tier_mismatch_stream_aborts_clean(sides):
    _both(sides, _tier_mismatch)


def _out_of_order(side):
    pf, dec = side.engine(), side.engine()
    prompt = _prompt(side)
    _, blobs = _export(side, pf, prompt, 1)
    assert len(blobs) >= 2
    ad = side.handoff.StreamAdopter(dec)
    with pytest.raises(ValueError, match="incompatible|out of order"):
        ad.feed(blobs[1])  # the second segment first
    side.balanced(dec)
    return len(blobs)


def test_out_of_order_segment_aborts(sides):
    _both(sides, _out_of_order)


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quantized_stream_crosses_packages(sides, tier):
    """A quantized pool's stream, exported by the JAX package and adopted
    by the port, and the reverse: the bytes and scale planes land verbatim
    and the decode side's parse equals the exporter's own cold parse."""
    for a, b in (("jax", "port"), ("port", "jax")):
        src, dst = sides[a], sides[b]
        pf, dec = src.engine(tier), dst.engine(tier)
        prompt = _prompt(src)
        out, blobs = _export(src, pf, prompt, 2, "q")
        assert out["ok"] and len(blobs) >= 2
        ad = dst.handoff.StreamAdopter(dec)
        for blob in blobs:
            ad.feed(blob)
        assert ad.feed(dst.handoff.pack_kv_end("q", {"ok": True}))["adopted_tokens"] > 0
        moved = dst.run(dec, [prompt], 24)[0]
        cold = src.run(src.engine(tier), [prompt], 24)[0]
        assert moved.token_ids == cold.token_ids, (a, b)
        dst.balanced(dec)


# ---------------------------------------------------------------- routes


def _port_brain(side, eng):
    from tpu_voice_agent_torch.services import brain

    parser = brain.BatchedEngineParser(eng, max_new_tokens=24, session_aware=True)
    srv = brain.make_server(brain.BrainApp(parser), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def close():
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
        parser.close()

    return parser, srv.server_address[1], close


def _read_frames(port: int, body: dict):
    """POST /admin/disagg/prefill and read the chunked body as it comes:
    (status, headers, [(seq, payload, final)], torn)."""
    from tpu_voice_agent_torch.serve import handoff

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/admin/disagg/prefill", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    frames, buf, torn = [], b"", False
    try:
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            buf += chunk
            got, buf = handoff.frame_feed(buf)
            frames.extend(got)
    except (http.client.IncompleteRead, ConnectionError):
        torn = True
    finally:
        conn.close()
    return resp.status, dict(resp.headers), frames, torn or bool(buf) or \
        not (frames and frames[-1][2])


@pytest.mark.parametrize("decode_pkg", ["port", "jax"])
def test_prefill_route_streams_frames_a_decode_brain_adopts(sides, decode_pkg):
    """The port's prefill brain answers ``/admin/disagg/prefill`` with
    chunked ``TVAF1`` frames, the ``kv_end`` summary last; each payload,
    forwarded to ``/admin/disagg/adopt`` on a decode brain of either
    package, lands, and that brain's parse of the prompt is then warm and
    equal to a cold one."""
    import httpx

    port_side, dside = sides["port"], sides[decode_pkg]
    parser, pport, close = _port_brain(port_side, port_side.engine())
    deng = dside.engine()
    if decode_pkg == "jax":
        dparser = dside.brain.BatchedEngineParser(deng, max_new_tokens=24, session_aware=True)
        dsrv = AppServer(dside.brain.build_app(dparser)).__enter__()
        durl, dclose = dsrv.url, lambda: (dsrv.__exit__(None, None, None), dparser.close())
    else:
        dparser, dport, dclose = _port_brain(dside, deng)
        durl = f"http://127.0.0.1:{dport}"
    try:
        status, headers, frames, torn = _read_frames(
            pport, {"text": PROMPT_TEXT, "context": _context(), "stream_blocks": 1,
                    "stream": "st1"})
        assert status == 200 and not torn
        assert headers["x-disagg-stream"] == "st1"
        assert headers["Content-Type"] == "application/x-tva-frames"
        assert [s for s, _, _ in frames] == list(range(len(frames))) and len(frames) >= 3
        meta, _ = port_side.handoff.unpack(frames[-1][1])
        assert meta["kind"] == "kv_end" and meta["ok"] is True
        assert meta["segments"] == len(frames) - 1
        for _, payload, final in frames:
            out = httpx.post(durl + "/admin/disagg/adopt", content=payload,
                             headers={"x-disagg-stream": "st1"}, timeout=60).json()
            assert out["ok"] is True and out["final"] == final, out
        assert out["adopted_tokens"] == meta["chain_tokens"]
        prompt = _prompt(dside)
        ids = deng.tokenizer.encode(prompt, bos=True)
        assert dside.tree(deng).cached_tokens(ids) >= meta["chain_tokens"]
        fut = (dparser.runtime.submit_parse(prompt) if decode_pkg == "jax"
               else dparser.loop.submit(prompt))
        warm = fut.result(timeout=300)
        cold = dside.run(dside.engine(), [prompt], 24)[0]
        assert warm.token_ids == cold.token_ids
        assert warm.cached_tokens >= meta["chain_tokens"]
        missing = httpx.post(durl + "/admin/disagg/adopt", content=frames[0][1], timeout=60)
        assert missing.status_code == 400 and missing.json() == {
            "error": "invalid_request", "detail": "x-disagg-stream header required"}
    finally:
        close()
        dclose()


def test_a_killed_prefill_brain_tears_the_stream(sides):
    """``prefill_replica_kill`` fires between frame writes: the connection
    closes with no final chunk after the frames already sent, and the
    prefill brain's own pool stays balanced (its export commits locally)."""
    from tpu_voice_agent_torch.utils import chaos

    side = sides["port"]
    eng = side.engine()
    parser, pport, close = _port_brain(side, eng)
    try:
        chaos.configure("prefill_replica_kill@3")
        status, _, frames, torn = _read_frames(
            pport, {"text": PROMPT_TEXT, "context": _context(), "stream_blocks": 1})
        assert status == 200 and torn and len(frames) == 2
        assert not any(final for _, _, final in frames)
        parser.loop.run_until_idle(timeout_s=120)
        import time

        for _ in range(200):  # the export finishes on the loop's thread
            if not parser.batcher.busy() and eng.allocator.blocks_in_use == eng.radix.nodes:
                break
            time.sleep(0.05)
        side.balanced(eng)
    finally:
        close()


def test_a_shed_export_answers_json(sides):
    """A prompt that ships nothing (the prefix alone covers it) answers one
    JSON body, as JAX's does when no segment was emitted."""
    side = sides["port"]
    parser, pport, close = _port_brain(side, side.engine())
    try:
        conn = http.client.HTTPConnection("127.0.0.1", pport, timeout=60)
        conn.request("POST", "/admin/disagg/prefill", body=json.dumps({"text": "go back"}))
        r = conn.getresponse()
        body = json.loads(r.read())
        conn.close()
        assert r.status == 200 and body["disagg_prefill"] is True and body["ok"] is True
        assert body["segments"] == 0
        conn = http.client.HTTPConnection("127.0.0.1", pport, timeout=60)
        conn.request("POST", "/admin/disagg/prefill", body=b"not json")
        r = conn.getresponse()
        assert (r.status, json.loads(r.read())) == (
            400, {"error": "invalid_request", "detail": "body must be JSON"})
        conn.close()
    finally:
        close()
