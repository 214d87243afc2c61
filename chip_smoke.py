#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``tpu_voice_agent_torch``) on one card.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, in order (any failure exits nonzero and prints no result line):

1. card     - the card's first touch under the bring-up watchdog
              (``utils.devinit.require_card``), its name and power limit
              (nvidia-smi).
2. build    - nvcc builds ``tpu_voice_agent_torch/csrc/*.cu`` (one process
              per source, started together) into the kernel library; the
              compile sentinel records it as one ``ops._lib.build`` event.
3. kernels  - each kernel at the main path's shapes against its plain PyTorch
              version on the card: max abs error vs a stated tolerance, kernel
              / plain / library ms, and the least time the card could take;
              first (``digest``) the SHA-256 of K1's, K2's, K3's, K5's and
              (bf16 and fp32 queries) K6's to K9's outputs on seeded inputs,
              so two builds can be held to the same bits, and K5's and K6's
              to K9's bf16 outputs held equal over two calls. K5 also at the
              batched STT plane's B = 4, kv_len (1500, 1000, 500, 0), with
              NaN past each kv_len. K8, K9 and K10 also at head dim 128,
              mixtral-8x7b's 32/8 heads (K9 at its (8, 9) drain block, K8
              at its T = 1 step, K10 at a dense (1, 2048, 8, 128) cache),
              int8 and int4, bf16 and fp32 queries. K4 and K11 are
              held exactly over every state of the intent grammar and timed
              warm and cold (L2 flushed, new states each launch) at the
              path's rows, beside the launch floor. K1 with its log-sum-exp
              (the ring's blocks) at the planner's largest bucket, causal
              T = 8192, 32/4 heads of 64: bf16, bf16 with an fp32 output,
              and fp32, output and lse; a shape of K1's row, "lse".
3b. hf_import - checkpoint import (BRAIN_MODEL, VOICE_STT=whisper-hf):
              HF-layout directories written into a temporary directory
              (deleted after) from seeded trees at published widths, BF16
              shards by this script's own safetensors writer: TinyLlama-1.1B
              (2 shards, a 32,000-piece SentencePiece-style tokenizer.json
              with merges trained on the prompt corpus), whisper-large-v3
              (byte-level, 51,866 ids with Whisper's control tokens) and the
              mixtral-8x7b layout cut to 1 layer. Each load bit-equal to its
              seeded tree (GB/s printed); the FSM build over the checkpoint
              tokenizer timed; a BRAIN_MODEL BRAIN_QUANT=int8 brain answers
              2 of the 5 utterances 200 with intents that parse (K1, K3), its
              int8 tree equal to quantize_params of the seeded tree and its
              tokens to an engine given the tokenizer and the tree (bf16)
              and, in an fp32 twin (HF_TWIN_NEW_TOKENS), from_hf's to the
              tree's; a BRAIN_PAGED=1
              BRAIN_BATCH=32 brain's 32-session drain, all in the grammar
              (at ff 0, as JAX builds it: K6); the whisper-hf voice
              service's paced utterance (K1, K5),
              its transcript tokens equal to an engine given the tree, no
              control token emitted; the Mixtral directory under
              BRAIN_MOE=grouped BRAIN_QUANT=int8 answering 200 (K13). At
              V = 32,000 S·V is past the dense-mask limit: K4 / K11 must stay
              at 0 (printed with S, V and the limit). The load rates, FSM
              build, peak card memory and phase time are printed.
4. service  - the port's brain service in-process on an ephemeral port with
              BRAIN_BACKEND=engine:tinyllama-1.1b BRAIN_QUANT=int8 (ff 8, the
              cached prompt prefix), answering /parse requests with bench.py's
              utterances; the K1, K3 and K4 launch counters must grow.
5. parse    - engine-level generate(max_new_tokens=64), bench.py's parse
              definition (to EOS or 64 tokens), p50 over 5 runs at ff=8 and
              at ff=0 on the same weights, with tokens and forwards beside;
              K3's counter must grow at ff=8 and K2's at ff=0.
6. batch    - bench_batch.py's paged run_one on the port: a 32-slot paged
              engine (513 blocks of 128) behind the cached prefix, 32 sessions
              submitted at once and drained (128 new tokens), at ff=8 (K7)
              and ff=0 (K6): intents/s, tokens/s, chunks, peak pool blocks;
              all 32 must be ok and in the grammar, and the pool must return
              to the prefix's blocks.
7. batch_dense - the dense batched engine (8 dense cache lines, no pool)
              drains 8 sessions at ff=8 (K3) and ff=0 (K2) and must decode
              what the paged engine decodes (or part only at a near tie), in
              bf16 and in fp32 activations.
8. radix    - RADIX_ENABLE's paged engine behind a BatchedEngineParser, 4
              sessions x 4 turns through its transcripts: turns >= 2 must be
              served from more cache than the prefix, and a radix-off engine
              must decode the same ids (or part only at a near tie).
9. kvquant  - the batch phase's drain with KV_QUANT=int8 and int4, the pool at
              the bf16 cell's byte budget (994 and 1,931 blocks), at ff=8 (K9)
              and ff=0 (K8), K6 and K7 never launched: intents/s, tokens/s,
              peak pool blocks and bytes, and how many sessions decode the
              bf16 drain's ids; then radix on against off at int8 with fp32
              activations, and one /parse of a BRAIN_PAGED=1 KV_QUANT=int8
              brain, which must answer 200.
10. spec    - speculative decoding (SPEC_ENABLE, K = 4): the parse phase's
              engine with the fsm,prompt drafters and with the self-draft
              (p50, verify forwards, accept rate, tokens per forward); the
              batch phase's drain on the bf16 pool (K7) and the int8 pool
              (K9), every verify tail one K11 launch, K6 / K8 never inside
              the decoder; each stream must equal the ff=0 stream or part
              only at a near tie; and a BRAIN_BATCH=8 BRAIN_PAGED=1
              RADIX_ENABLE=1 SPEC_ENABLE=1 brain answering two /parse turns
              of one session with 200.
11. quality - the quality lanes (QUALITY_ENABLE unset: on) at full width:
              the batch phase's 32 sessions through the paged engine at ff=8
              (K7) and through the paged spec engine (K7, K11), each
              drained with the lanes on and then off on the same engine
              object: equal tokens, ``quality`` on every result with the
              lanes on and None off; the first recorded batch of lanes
              against an fp64 recomputation on the CPU; one chunk's wall
              and device kernels per forward (torch.profiler), lanes on
              and off.
11b. containment - fault containment and incident capture on the batch
              phase's engines (tinyllama-1.1b int8, 32 paged slots): K4 on
              a batch mixing NaN, dead-state and healthy rows against its
              plain version (healthy and dead rows equal, NaN rows in
              range) and the poison gate; the 32 requests clean, then under
              chaos ``nan_logits@3,dead_fsm@7,prefill_exc@11,alloc_fail@5``
              on the bf16 pool (K7), the int8 pool (K9) and the spec engine
              (K7, K11): exactly the three drilled requests fail with JAX's
              typed errors, the 29 others decode their clean tokens; one
              prompt poisoned QUARANTINE_AFTER times is refused at submit,
              the flight recorder froze with ``scheduler.quarantine`` and
              the step ledger, the pool is back at its free blocks; a 1 ms
              budget behind a full batch sheds at dequeue, a request
              abandoned after one chunk is evicted at once, batch-mates
              equal; PREFILL_CHUNK_TOKENS 16 and 256 (int8: 16) against
              the barrier admission (equal, or parted at a near tie: in
              bf16 activations within 32 bf16 ulps of the top-2 margin, in
              a twin with fp32 activations within one); TTFT
              of 8 short requests behind one 1000-token prompt, chunking
              off / 256 / 16 (a reading); the step ledger over a drain at
              ff 8 and ff 0 (every step's stages tile its wall within 5%;
              the median stage split, admitting and decode-only steps); a
              brain over HTTP at max_inflight 2 (4 concurrent parses: 503 +
              Retry-After, ``resilience.brain.shed_overload``),
              ``/debug/steplog`` and ``/debug/flightrecorder`` 200, and a
              client socket closed mid-parse cancelling its decode.
11d. tenancy - the tenancy plane on the batch phase's engine (radix on,
              TENANT_CLASSES=premium:4:slots=24,free:1:rps=4): with the knob
              unset no plane and the requests' cost ledgers sum to the
              meter's totals (==); on, the 32 prompts over premium (its
              24-slot cap binding) and the default class decode the unset
              run's tokens bit for bit (K7); 16 free requests at once: 4
              decode, 12 shed with JAX's "shed: tenant free rate-limited";
              at ff 0 (K6) two premium and two free requests behind 32
              default ones preempt default slots (warm release into the
              tenant's radix namespace), and every request decodes the
              untenanted run's tokens or parts at a near tie (32 bf16 ulps;
              one in a twin with fp32 activations), the tenant ledgers
              summing to the totals; a batched brain over HTTP lanes an
              ``x-tenant`` parse and a body ``tenant`` parse, and
              ``/debug/costs`` reports MFU and MBU against the H100 entry.
11e. handoff - the brain's warm state at tinyllama-1.1b int8 (32 slots, 513
              blocks of 128, radix on, the cached prefix): per pool tier
              (bf16, int8, int4) 2 sessions play 2 turns on a donor engine,
              each is exported and POSTed to ``/admin/handoff`` on a port
              brain around a recipient engine, and turn 3 runs batched on
              both: the recipient's tokens equal the donor's stay-home ones
              or part at a near tie (32 bf16 ulps; one in an fp32-activation
              twin on the bf16 pool), blob bytes, export and adopt ms, the
              admitting step warm against ``HANDOFF_KV=0`` blobs on the same
              recipient after its ``warm_restart``, no leaked block on
              either engine (K7 / K9 read the adopted blocks). Then the
              disagg stream: ``/admin/disagg/prefill`` on one brain runs a
              prompt of ~1,000 tokens past the prefix with stream_blocks 4,
              its frames read as they arrive and forwarded to
              ``/admin/disagg/adopt`` on another; that brain's parse is warm
              and equals a cold engine's (bf16 within 32 ulps, the fp32 twin
              within one); time to the first frame against the export's
              wall. Prefix feeds: 4 prompts fed as growing prefixes, then
              parsed, against the same unfed (cached tokens, the admitting
              step's prefill ms). The watchdog drill: CHAOS_FAULTS=
              stall_step@2, ENGINE_STALL_S 5 s (or 3x a fresh run's
              slowest step), CHAOS_STALL_S 3 s past it, 8 parses
              decoding over HTTP when step 2 stalls: each fails with JAX's
              text, one ``engine.restarts``, no kernel launch from the
              stalled thread after the supersede, and the next 32 parses
              over HTTP to the same brain token for token a fresh
              engine's. Drain: ``POST /admin/drain`` on the distilled
              checkpoint's batched brain with 4 parses in flight: all 200,
              a later parse served, ``/health`` draining at once and
              drained once both lanes are empty.
11f. fleet   - the fleet at tinyllama-1.1b int8 on the service phase's weights:
              three port brains (BRAIN_BATCH=8 BRAIN_PAGED=1 RADIX_ENABLE=1,
              one weight set) on the card, each on its own port, behind the
              port's router on its own port (HANDOFF_ENABLE=1; the drill
              drives every probe sweep). Affinity: 6 sessions x 2 turns,
              each on its rendezvous home, turn 2 cached past the prefix.
              Drain: ``POST /admin/drain`` on the member with the most
              sessions while 4 parses are in flight on it (all 200); its
              sessions' turn 3 re-homes warm and equals their stay-home turn
              3 on the drained member (32 bf16 ulps; a two-member
              fp32-activation twin at one). Crash: ``replica_kill@1`` as 8
              parses homed on a member arrive: all 200 inside
              ``x-deadline-ms`` through the retry, moves counted cold, the
              member ejected by two sweeps. Gray: ``replica_degrade@1``
              (CHAOS_SLOW_S=3) on a fresh router at the default
              FLEET_GRAY_MAD (4): gray within FLEET_GRAY_WINDOWS windows of
              ``/debug/timeseries`` scrapes on ``fwd_ms``, no healthy member
              gray; new sessions avoid it, a sticky one stays. The phase
              lifts the SLO targets; the affinity and gray drills print what
              each brain's pressure would read at the default ones.
              Disagg: ROUTER_DISAGG=1 with one member ``#prefill``, a prompt
              of ~1,000 tokens past the prefix: one admission, the decode
              home's parse warm and equal to a cold engine's. Autopilot:
              ``tick_once`` with a spawner over in-process port brains: a
              scale-up pre-warmed through the handoff, a scale-down with 6
              parses in flight (all 200), the retired brain's blocks back to
              its tree. Each drill's wall, the router's counters and each
              brain's K1 / K3 / K4 / K6 / K7 calls by its serving threads.
11g. devobs - device observability on the batch cell's brain (tinyllama
              int8, ff 8, 8 paged slots, the service phase's weights): the
              build's sentinel event; every site cold again, the warm-up
              parses' events; the fence armed, a repeated parse pays no
              event, a prompt in the cold 64-token suffix bucket exactly
              one, named, in ``/health``'s warning, in
              ``xla.compiles_post_fence`` and on its step in the ledger;
              the HBM ledger's plan against the engine's tensors and
              ``torch.cuda.memory_stats``; the ``_qe`` dequant audit of a
              decode step (count, MB); a ``capture_profile`` Chrome trace
              (``chiprun_out/devobs/trace.json``).
11h. planner - the long-session planner (``serve/planner.py``) at
              tinyllama-1.1b on the weights the ``planner`` backend serves
              (random bf16 from seed 0), sp 1 on the card: ``ring_attention`` at sp 4 over [cuda:0] x 4 (the
              multi-block lse merge) against one K1 call, causal T = 8192;
              ``llama_sp_prefill`` against the dense fresh-block forward on
              the 2048 bucket (last logits within 32 bf16 ulps, an fp32-
              activation twin within one; k/v); the cold-start prefill ms
              per bucket (1024-8192); a cold start from the rendered prompt
              (2048 bucket), plan, warm extend, plan, a re-anchor into 4096,
              plan; a 6,000-token session in 8192; ``plan_many`` of 4
              sessions against 4 sequential plans (equal, or parted at a near
              tie) with every slot 0 intact; one 8-token plan under the
              profiler (CUDA activity: the idle share); plans cut to 32
              tokens. Every ring prefill
              is 22 K1 launches (with lse). Then BRAIN_BACKEND=planner-distilled
              over HTTP on the 6 golden dialogs with session ids, every
              turn's tokens equal to ``data/planner_golden.json`` (fp32),
              ``score_parser_dialogs`` printed; BRAIN_BACKEND=planner booting
              and answering two turns of one session (200 or a 422
              truncation); BRAIN_SP past the cards refused at boot, naming
              it. K1, K2 and K4 must launch.
11i. parallel - the dp x tp mesh and the pp x tp pipeline
              (``parallel/``, ``serve/pp_engine.py``) on meshes of four
              devices that are all the one card ([cuda:0] x 4), at
              tinyllama-1.1b's width int8 on the first 8 of the service
              phase's 22 layers: each
              sharded wrapper (K1, K2, K3, K5, K4, K11) against its plain
              version, K1 / K2 / K3 also timed at a tp-2 shard's shape (the
              ``tp2_shard`` shape of their rows); the dense engine on a
              dp 2 x tp 2 mesh (4 slots, the vocab padded to 620, the
              cached prefix: 8 x 2 K1 launches) serving the five typed
              commands (32 new tokens) at ff 8 (K3: exactly 8 x 4 a
              forward; K4 per dp shard) against the unmeshed engine, spec
              k = 4 on the same mesh (K3, K11 per shard) against its ff 0
              (K2: 8 x 4 a forward); ``PPDecodeEngine`` at pp 2 x tp 2
              (int8, ff 0, the cached prefix) against the unmeshed ff 0
              engine; bf16 streams equal or parted within 32 bf16 ulps of
              the plain forward's top-2 margin, twins with fp32 activations
              within one; parse walls, tok/s and one 4-step chunk's device
              idle share at 2 x 2 against 1 x 1. Then BRAIN_BACKEND=pp
              through the brain service at its one-card defaults (pp 1 x
              tp 1, ff 0) answering /parse (200, or a 422 truncation) and
              /health, and the refusals: BRAIN_PP=2 on one card, a paged
              engine on a mesh.
11c. service_batched - a second in-process brain with BRAIN_BATCH=8
              BRAIN_PAGED=1 RADIX_ENABLE=1 answering 8 concurrent /parse.
12. golden  - the distilled intent checkpoint parses the golden utterances and
              must reproduce the JAX package's recorded outputs token for
              token, through K1, K2 and K4.
13. batch_golden - the same checkpoint in a 15-slot paged engine, every
              golden utterance at once, through K1, K6 and K4.
14. kvquant_golden - the same on the int8 and on the int4 pool, each equal
              to the JAX package's recording for that tier, through K1, K8
              and K4; then ``kv_quant_differential`` on 6 golden cases must
              hold the JAX test's floors.
15. spec_golden - the same recordings under speculation: single slot (K3,
              K11), 15-slot paged at bf16 (K7), int8 and int4 (K9), and the
              self-draft, which must accept > 0.9 at > 2 tokens a forward.
16. stt     - SpeechEngine("whisper-large-v3", frame_buckets=(300, 1000),
              max_new_tokens=32), bf16 random weights: per bucket the
              transcribe wall of 1 run split into encode and decode ms,
              tokens and forwards; one incremental feed + decode; the first
              decoder step through K5 held against the same step through its
              plain version (fp32 copies of the weights). K1 and K5 must
              launch. Then the STT lanes on one transcribe: equal tokens
              with the lanes off, the lanes against an fp64 log-softmax of
              the recorded step logits, walls and device kernels per
              decoder forward, lanes on and off.
17. voice   - the voice→intent loop (``voicebench``, bench.py's definition)
              at full width: whisper-large-v3 STT and the tinyllama-1.1b int8
              ff=8 parse colocated on the card, 3 utterances; K1, K3, K4 and
              K5 must launch. Then bench.py's --neural loop
              (``voicebench.run_neural_voice_bench``): the distilled parser
              and whisper-tiny-heldout, 3 runs over five eval texts, p50 /
              p95 and each run's WER (K1, K2, K4, K5).
18. voice_service - the port's voice WS service (``services/voice.py``)
              driven through its own client (``services/ws.py``): the
              service phase's brain and a stub executor in-process, the voice
              service at VOICE_STT=whisper:whisper-large-v3 (random weights,
              SpeechEngine's defaults), all on ephemeral ports. 2 utterances
              of synth_utterance(2.0) + 1 s of silence as 60 ms PCM16 frames
              at real-time pace, chaos ``drop_frame@5`` armed (exactly one
              frame dropped; K1 and K5 must launch; every frame in the
              vocabulary; no error or execution_error frame, every
              transcript_final followed by its intent; finals and
              latency_budget stages reported); the five
              utterances above as typed commands, each transcript_final then
              a valid, non-degraded intent, confirmation_required for exactly
              its risky intents, execution_result for its safe ones, which the
              stub must receive, the first session id threaded into every
              later /execute, /health ok (K3, K4: the prompt suffix behind the
              cached prefix takes the plain cache attention, as in JAX); then
              VOICE_STT=whisper-ckpt:checkpoints/whisper-tiny-overfit and
              the brain booted from BRAIN_BACKEND=distilled on the card
              must read "search for red shoes" as a search for "red shoes"
              and execute it (K1, K2, K4, K5), then answer two typed
              commands with their recorded intents: "scroll down"
              executed, "upload my cover letter and submit it" held for
              confirmation (K1, K2, K4). Every final carries JAX's
              ``confidence`` and every parse its x-intent-margin (in the
              latency_budget stages), each within 1e-3 of the same stack
              run on the CPU; both services' /metrics (JSON and
              Prometheus), /debug/quality and /debug/trace/<id> are
              scraped and held to the run's counts.
18b. stt_batch - the batched STT plane (STT_BATCH_SLOTS=4) on
              whisper-large-v3 at the stt phase's shape, bf16 random
              weights: 11 work items over 3 ticks (4 ragged finals; two
              partials, a spec_final, a final; the partials' slots again and
              a final) each against the B = 1 path (transcribe, or an
              IncrementalState fed the same audio): equal tokens, or a
              parting within 32 bf16 ulps of the B = 1 decoder's top-2
              margin; on fp32 copies of the weights, round 2's 4 items,
              within one (K1, K5 at B = 4 with ragged kv_len). Then the
              voice service's paced
              utterance behind the rule brain and a stub executor on the
              batched plane on 3 connections at once (each the same
              audio: a one-connection run repeated it, so it went): the drain
              after the last frame, partials, coalesced and shed partials,
              batched ticks (the locked plane's run of the same audio is
              voice_service's). Between the bf16 and fp32 items, the
              replicated tier (``STTReplicaTier``, 2 replicas x 4 slots) on
              the same 11 items, round by round: clean (equal to B = 1 or
              within 32 ulps), with ``stt_replica_kill@1`` (no final lost,
              finals equal, one warm restart), and one ``stt_replica_hang``
              drill (the stalled-tick restart, the hung worker launching
              nothing, round 1 then bit-equal to the clean run's).
19. stt_golden - both in-repo Whisper checkpoints (fp32, head dim 16)
              transcribe the 10 eval texts and must reproduce the JAX
              package's recorded token ids, through K1 and K5.
20. moe     - the MoE decoder, last (its engines take 46 GB each): the
              mixtral-test engine in fp32 on one weight set, grouped (K13) on
              the card against dense on the card and grouped on the CPU, 4
              prompts token-identical or parted at a near tie; then
              BRAIN_BACKEND=engine:mixtral-8x7b BRAIN_QUANT=int8 behind
              BrainApp, BRAIN_MOE=grouped and then dense: 2 /parse (dense:
              1), 200
              and grammar-valid, K13 exactly 3 x 32 launches a forward (0 on
              the dense dispatch), the peak allocation under the card's
              memory; then BRAIN_PAGED=1 BRAIN_BATCH=8 grouped, an 8-session
              drain through K7 and K13; then, over that engine's weight
              tensors, the same drain under KV_QUANT=int8 and int4 (K9,
              K13; K6 and K7 never) and int8 at ff 0 (K8), agreement with
              the bf16 drain reported, and ``/health`` of each pool reading
              256 / 130 / 66 bytes a (position, kv head) with the HBM plan's
              drift within ``HBM_DRIFT_WARN``; last the fp32-activation twin
              at mixtral-8x7b's attention widths cut to 2 layers and ffn 512
              (int8 and int4, the card against the CPU, token-identical or
              parted at a near tie).
21. the kernels JSON line, the card line, and the final JSON line.

Every launch counter is set to 0 just before each of phases 3b-20 (each of the
voice_service phase's four runs, and of the hf_import phase's brains, drain
and voice run) and read just after; a kernel's
``launches`` is the sum over those runs (the kernel-alone comparisons of
phase 3 are not counted). The port imports no JAX. Weights are random from a
seed (phases 3-11h but 11e's drain and 11h's planner-distilled, 16, 17, 18's
first two runs, 18b, 20) or committed checkpoints (11e's drain, 11h's
planner-distilled, 12-15, 18's last two runs, 19). A JSON report also goes to
``chip_smoke.json`` in ``OUT_DIR``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet, dense): the bound_ms denominators
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores: the attention products
FP32_FLOPS = 67e12  # CUDA cores: K4's compares

# Where each ported kernel's TPU original reaches pl.pallas_call
REPLACES = {
    "flash_attention": "tpu_voice_agent/ops/flash_attention.py:158",
    "decode_attention": "tpu_voice_agent/ops/decode_attention.py:133",
    "decode_attention_layer": "tpu_voice_agent/ops/decode_attention.py:223",
    "decode_block_attention_layer": "tpu_voice_agent/ops/decode_attention.py:542",
    "masked_argmax_advance": "tpu_voice_agent/ops/grammar_mask.py:268",
    "paged_attention": "tpu_voice_agent/ops/paged_attention.py:147",
    "paged_block_attention": "tpu_voice_agent/ops/paged_attention.py:644",
    "paged_attention_quant": "tpu_voice_agent/ops/paged_attention.py:333",
    "paged_block_attention_quant": "tpu_voice_agent/ops/paged_attention.py:834",
    "decode_attention_quant": "tpu_voice_agent/ops/decode_attention.py:722",
    "masked_argmax": "tpu_voice_agent/ops/grammar_mask.py:107",
    "decode_block_attention": "tpu_voice_agent/ops/decode_attention.py:458",
    "grouped_matmul": "tpu_voice_agent/ops/grouped_matmul.py:97",
}
SOURCES = {
    "flash_attention": "tpu_voice_agent_torch/csrc/flash_attention.cu",
    "decode_attention": "tpu_voice_agent_torch/csrc/decode_attention.cu",
    "decode_attention_layer": "tpu_voice_agent_torch/csrc/decode_block_attention.cu",
    "decode_block_attention_layer": "tpu_voice_agent_torch/csrc/decode_block_attention.cu",
    "masked_argmax_advance": "tpu_voice_agent_torch/csrc/grammar_mask.cu",
    "paged_attention": "tpu_voice_agent_torch/csrc/paged_attention.cu",
    "paged_block_attention": "tpu_voice_agent_torch/csrc/paged_attention.cu",
    "paged_attention_quant": "tpu_voice_agent_torch/csrc/paged_attention_quant.cu",
    "paged_block_attention_quant": "tpu_voice_agent_torch/csrc/paged_attention_quant.cu",
    "decode_attention_quant": "tpu_voice_agent_torch/csrc/decode_attention_quant.cu",
    "masked_argmax": "tpu_voice_agent_torch/csrc/grammar_mask.cu",
    "decode_block_attention": "tpu_voice_agent_torch/csrc/decode_block_attention.cu",
    "grouped_matmul": "tpu_voice_agent_torch/csrc/grouped_matmul.cu",
}
# bf16 attention outputs, held element by element to the reference's own
# size: |out - ref| <= ATTN_RTOL * |ref| + ATTN_ATOL. The kernel and its
# plain version each round an fp32 result to bf16 (at most one ulp, which is
# <= 2^-7 |x|, each); ATTN_ATOL covers the fp32 sums taken in another order,
# which matter only where the output is near 0. A frontier off by one key
# (weight ~1/900 at the main path's lengths) moves outputs by several percent.
ATTN_RTOL, ATTN_ATOL = 2.0 ** -6, 1e-4
ATTN_TOL = f"{ATTN_RTOL:g}*|ref|+{ATTN_ATOL:g}"
# fp32 attention outputs (the in-repo Whisper checkpoints): no rounding on
# either side, only fp32 sums and exponentials taken in another order, each
# within a few ulp (~1e-7 relative) of the exact value
F32_RTOL, F32_ATOL = 1e-5, 1e-6
F32_TOL = f"{F32_RTOL:g}*|ref|+{F32_ATOL:g}"
# K13 (grouped matmul) sums d = 4096 or 14336 products per output, in another
# order than its plain version (the tensor-core path adds 16-wide partial
# products): that error scales with the sum of |terms|, so on top of each
# side's one rounding (the bf16 rule above, or 1e-5 in fp32) an output may
# differ by GMM_SUM_TOL * sum_k |x_ik| * |w_kj|. A row gathered from the
# wrong expert or tile moves an output by ~1e-2 of that sum.
GMM_SUM_TOL = 2.0 ** -16
GMM_TOL = (f"bf16 {ATTN_TOL}+2^-16*sum|x||w|; fp32 {F32_RTOL:g}*|ref|+2^-16*sum|x||w|; "
           "int8 leaf == dense on its dequantized values, bit for bit")

# bench.py's utterances (its synthetic voice traffic, bench.py:238-244)
UTTERANCES = [
    "search for wireless headphones",
    "sort these by price from low to high",
    "open the second result and take a screenshot",
    "filter results under one hundred dollars",
    "upload my resume and submit the form",
]


class SmokeFailure(RuntimeError):
    pass


_T_START = time.perf_counter()  # the script's clock, from its import


def log(msg: str) -> None:
    """Print a line; a phase's line (``[name] ...``) ends with the script's
    clock, so a run shows where its time goes."""
    if msg.startswith("["):
        msg = f"{msg} @{time.perf_counter() - _T_START:.1f}s"
    print(msg, flush=True)


def fail_if(cond: bool, msg: str) -> None:
    if cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------------ timing

_CYCLES_PER_MS: list[float] = []


def _cycles_per_ms() -> float:
    """The card's clock, measured: a ``torch.cuda._sleep`` spin timed by
    CUDA events."""
    import torch

    if not _CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        cycles = 20_000_000
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _CYCLES_PER_MS[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back launches.

    The card first spins (``torch.cuda._sleep``) for longer than the host
    takes to enqueue all of them, so the CUDA events time the kernels
    themselves and not the host's launch gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(_cycles_per_ms() * (2 * enqueue_ms + 2)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases


def phase_card() -> str:
    """The card's first touch under the bring-up watchdog
    (``utils.devinit.require_card``: a hang exits naming the card, a failure
    raises), then its name and power limit from nvidia-smi."""
    from tpu_voice_agent_torch.utils.devinit import require_card

    log(f"[card] cuda:0 up: {require_card()}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    fail_if(out.returncode != 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    log(f"[card] {line}")
    return line


def phase_build(report: dict) -> float:
    """nvcc over ``csrc/`` (ptxas's registers and spills to the log); the
    compile sentinel's ``ops._lib.build`` event of a build that compiled
    goes into the report for the devobs phase."""
    from tpu_voice_agent_torch.ops import _lib
    from tpu_voice_agent_torch.utils.compilewatch import get_compile_watcher

    _lib.build(verbose=True)
    info = dict(_lib.BUILD_INFO)  # library() below re-checks the cache
    report["build_event"] = next((e for e in get_compile_watcher().events()
                                  if e["site"] == "ops._lib.build"), None)
    fail_if(not info["cached"] and report["build_event"] is None,
            "build: the compile sentinel recorded no ops._lib.build event")
    _lib.library()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        f.write(info["log"])
    for ln in info["log"].splitlines():
        if "registers" in ln or "spill" in ln or ln.startswith("== "):
            log(f"[build] {ln.strip()}")
    log(f"[build] nvcc built {len(_lib.SOURCES)} sources in {info['seconds']:.2f} s "
        f"(cached={info['cached']})")
    return info["seconds"]


def attn_err(pairs) -> tuple[float, float]:
    """(max abs error, max of error / allowed error) over (out, ref) pairs,
    the allowed error being ATTN_RTOL * |ref| + ATTN_ATOL element by element
    for bf16 outputs and F32_RTOL * |ref| + F32_ATOL for fp32 ones: the check
    passes when the second number is <= 1."""
    import torch

    worst_abs = worst_ratio = 0.0
    for out, ref in pairs:
        rtol, atol = ((F32_RTOL, F32_ATOL) if out.dtype == torch.float32
                      else (ATTN_RTOL, ATTN_ATOL))
        d = (out.float() - ref.float()).abs()
        worst_abs = max(worst_abs, float(d.max()))
        worst_ratio = max(worst_ratio, float((d / (rtol * ref.float().abs() + atol)).max()))
    return worst_abs, worst_ratio


def _kernel_row(name, ref_err, ratio, tol, ms, plain_ms, bound_ms, bound_by, library_ms):
    """``ratio``: the largest error over its allowed error (<= 1 passes)."""
    fail_if(not ratio <= 1.0, f"{name}: error {ratio:.3g}x its tolerance {tol} "
            f"(max abs err {ref_err})")
    row = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name], "launches": 0, "max_abs_err": ref_err,
           "tol": tol, "err_over_tol": ratio, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
    log(f"[kernels] {name}: max_abs_err {ref_err:.3g} ({ratio:.3g} of tol {tol}) "
        f"kernel {ms:.5f} ms "
        f"plain {plain_ms:.5f} ms library "
        f"{'n/a' if library_ms is None else f'{library_ms:.5f} ms'} bound {bound_ms:.5f} ms "
        f"({bound_by})")
    return row


def _extra_shape(label, ms, plain_ms, bound_ms, bound_by, library_ms) -> dict:
    """A kernel's timing at a second main-path shape (kept beside its row)."""
    lib = "none" if library_ms is None else f"{library_ms:.5f} ms"
    log(f"[kernels]   {label}: kernel {ms:.5f} ms plain {plain_ms:.5f} ms library {lib} "
        f"bound {bound_ms:.5f} ms ({bound_by})")
    return {"shape": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_kernels(fsm, prefix_len: int) -> dict:
    """K1-K13 alone at the main path's shapes. The parse (tinyllama-1.1b: 32
    q heads, 4 kv heads, hd 64, 22 layers; service cache S = 2048; the prefix
    bucket T = 1024; fast-forward blocks of 9, speculative verify blocks of
    5; the intent grammar's tables)
    and the STT (whisper-large-v3: 20 heads, hd 64, bf16, MHA; encoder
    T = S = 500 at the 1000-frame bucket; decoder self cache S = 448 and
    cross-KV S = 500; the in-repo checkpoints: 4 heads, hd 16, fp32); the
    MoE feed-forward (``_gmm_kernel_rows``: mixtral-8x7b's experts); K4 and
    K11 (``_grammar_kernel_rows``)."""
    import torch
    import torch.nn.functional as F

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import (
        attention_reference,
        decode_attention_reference,
        decode_block_attention_reference,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    L, S, nq, nkv, hd = 22, 2048, 32, 4, 64
    group = nq // nkv
    bf = torch.bfloat16
    rows = {}

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    # K1: the prefix prefill bucket, causal
    T = 1024
    q, k, v = randn(1, T, nq, hd), randn(1, T, nkv, hd), randn(1, T, nkv, hd)
    out = ops.flash_attention(q, k, v, causal=True)
    ref = attention_reference(q, k, v, causal=True)
    # the Whisper encoder's non-causal mode: large-v3 at the 1000-frame
    # bucket (T = S = 500, 20 heads) and at an incremental block with its
    # lookback (T = S = 35), and the checkpoints (T = S = 100, 4 heads of
    # 16, fp32); a ragged kv_len too
    nh, Te = 20, 500
    qe, ke, ve = (randn(1, Te, nh, hd) for _ in range(3))
    qb, kb, vb = (randn(1, 35, nh, hd) for _ in range(3))
    q16, k16, v16 = (randn(1, 100, 4, 16, dtype=torch.float32) for _ in range(3))
    # mixtral-8x7b's causal prefix prefill: 32 q / 8 kv heads of 128
    qx, kx, vx = randn(1, T, 32, 128), randn(1, T, 8, 128), randn(1, T, 8, 128)
    k1_err = attn_err([(out, ref),
                       (ops.flash_attention(qx, kx, vx, causal=True),
                        attention_reference(qx, kx, vx, causal=True)),
                       (ops.flash_attention(q, k, v, causal=False, kv_len=1000),
                        attention_reference(q, k, v, causal=False, kv_len=1000)),
                       (ops.flash_attention(qe, ke, ve, causal=False),
                        attention_reference(qe, ke, ve, causal=False)),
                       (ops.flash_attention(qb, kb, vb, causal=False),
                        attention_reference(qb, kb, vb, causal=False)),
                       (ops.flash_attention(q16, k16, v16, causal=False),
                        attention_reference(q16, k16, v16, causal=False))])
    torch.cuda.synchronize()
    qh, kh, vh = (q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(group, 1),
                  v.transpose(1, 2).repeat_interleave(group, 1))
    pairs = T * (T + 1) / 2
    b_ms, b_by = bound(2 * (2 * T * nq * hd + 2 * T * nkv * hd), 4 * nq * hd * pairs)
    rows["flash_attention"] = _kernel_row(
        "flash_attention", *k1_err, f"{ATTN_TOL} (bf16); {F32_TOL} (fp32)",
        cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        cuda_ms(lambda: attention_reference(q, k, v, causal=True), iters=5),
        b_ms, b_by,
        cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)))
    # how often the bf16 outputs at the prefix shape round to the plain
    # version's bits: the prefix's k/v feed every later decode step
    rows["flash_attention"]["equal_to_plain"] = float((out == ref).float().mean())
    log(f"[kernels]   bf16 outputs equal to the plain version's: "
        f"{rows['flash_attention']['equal_to_plain']:.6f}")
    qeh, keh, veh = (x.transpose(1, 2) for x in (qe, ke, ve))
    rows["flash_attention"]["encoder"] = _extra_shape(
        "whisper-large-v3 encoder, non-causal T = S = 500, 20 heads, hd 64, bf16",
        cuda_ms(lambda: ops.flash_attention(qe, ke, ve, causal=False)),
        cuda_ms(lambda: attention_reference(qe, ke, ve, causal=False), iters=5),
        *bound(2 * 4 * Te * nh * hd, 4 * nh * hd * Te * Te),
        cuda_ms(lambda: F.scaled_dot_product_attention(qeh, keh, veh)))
    qxh, kxh, vxh = (qx.transpose(1, 2), kx.transpose(1, 2).repeat_interleave(4, 1),
                     vx.transpose(1, 2).repeat_interleave(4, 1))
    rows["flash_attention"]["mixtral"] = _extra_shape(
        "mixtral-8x7b prefix prefill, causal T = S = 1024, 32/8 heads, hd 128, bf16",
        cuda_ms(lambda: ops.flash_attention(qx, kx, vx, causal=True)),
        cuda_ms(lambda: attention_reference(qx, kx, vx, causal=True), iters=5),
        *bound(2 * (2 * T * 32 * 128 + 2 * T * 8 * 128), 4 * 32 * 128 * pairs),
        cuda_ms(lambda: F.scaled_dot_product_attention(qxh, kxh, vxh, is_causal=True)))
    del qxh, kxh, vxh

    rows["flash_attention"]["lse"] = _k1_lse_shape(randn, dev)

    # K5: one large-v3 decoder step's cross-attention (S = kv_len = 500, the
    # 1000-frame bucket; S = 1500, kv_len 75, the incremental buffer after
    # three blocks) and self-attention (S = 448, kv_len 33: the prompt and
    # 32 tokens); the checkpoints' fp32 hd-16 cache; ragged rows with one at
    # kv_len 0 (zeros)
    ck, cv = randn(1, Te, nh, hd), randn(1, Te, nh, hd)
    ik, iv = randn(1, 1500, nh, hd), randn(1, 1500, nh, hd)
    inc_len = torch.tensor([75], dtype=torch.int32, device=dev)
    sk, sv = randn(1, 448, nh, hd), randn(1, 448, nh, hd)
    q5 = randn(1, nh, hd)
    cross_len = torch.tensor([Te], dtype=torch.int32, device=dev)
    self_len = torch.tensor([33], dtype=torch.int32, device=dev)
    k16c, v16c = (randn(2, 100, 4, 16, dtype=torch.float32) for _ in range(2))
    q16d = randn(2, 4, 16, dtype=torch.float32)
    len16 = torch.tensor([37, 100], dtype=torch.int32, device=dev)
    kr, vr, qr = randn(4, 448, nh, hd), randn(4, 448, nh, hd), randn(4, nh, hd)
    len_r = torch.tensor([0, 1, 33, 448], dtype=torch.int32, device=dev)
    k5_cases = {"cross": (q5, ck, cv, cross_len), "incremental": (q5, ik, iv, inc_len),
                "self": (q5, sk, sv, self_len), "fp32": (q16d, k16c, v16c, len16),
                "ragged": (qr, kr, vr, len_r)}
    k5_pairs = []
    for label, args in k5_cases.items():
        out = ops.decode_attention(*args)
        # the key range is split across blocks (and, at Whisper's group of
        # 1, across warp sets) and merged in a fixed order: the same bits
        # from run to run
        fail_if(not torch.equal(out, ops.decode_attention(*args)),
                f"decode_attention ({label}): two calls on the same inputs differ")
        fail_if(not bool((out[args[3] == 0] == 0).all()),
                f"decode_attention ({label}): a row with kv_len 0 is not zeros")
        k5_pairs.append((out, decode_attention_reference(*args)))
    ckh, cvh = ck.transpose(1, 2), cv.transpose(1, 2)
    rows["decode_attention"] = _kernel_row(
        "decode_attention", *attn_err(k5_pairs), f"{ATTN_TOL} (bf16); {F32_TOL} (fp32)",
        cuda_ms(lambda: ops.decode_attention(q5, ck, cv, cross_len), iters=100),
        cuda_ms(lambda: decode_attention_reference(q5, ck, cv, cross_len)),
        *bound(2 * (2 * nh * hd + 2 * Te * nh * hd) + 4, 4 * nh * hd * Te),
        cuda_ms(lambda: F.scaled_dot_product_attention(q5[:, :, None], ckh, cvh), iters=100))
    rows["decode_attention"]["shape"] = (
        "whisper-large-v3 decoder cross-attention, S = kv_len = 500, 20 heads, hd 64, bf16; "
        "fp32 hd 16 and ragged rows (kv_len 0, 1, 33, 448) checked")
    rows["decode_attention"]["deterministic"] = True
    for label, n_keys in (("self", 33), ("incremental", 75)):
        qq, kk, vv, ll = k5_cases[label]
        kkh, vvh = kk[:, :n_keys].transpose(1, 2), vv[:, :n_keys].transpose(1, 2)
        rows["decode_attention"][label] = _extra_shape(
            f"whisper-large-v3 decoder {label} attention, S = {kk.shape[1]}, kv_len {n_keys}, "
            "20 heads, hd 64, bf16",
            cuda_ms(lambda: ops.decode_attention(qq, kk, vv, ll), iters=100),
            cuda_ms(lambda: decode_attention_reference(qq, kk, vv, ll)),
            *bound(2 * (2 * nh * hd + 2 * n_keys * nh * hd) + 4, 4 * nh * hd * n_keys),
            cuda_ms(lambda: F.scaled_dot_product_attention(qq[:, :, None], kkh, vvh), iters=100))
    rows["decode_attention"]["batched"] = _k5_batched_row(randn, dev)
    rows["decode_attention"]["one_key_set_ms"] = _one_key_set_ms(
        {label: k5_cases[label] for label in ("cross", "self", "incremental")})
    # the host's time a call (checks, scratch, one launch): the STT decode
    # step makes 64 of them and is host-bound
    rows["decode_attention"]["host_us"] = _host_us(
        lambda: ops.decode_attention(q5, ck, cv, cross_len))
    log(f"[kernels]   decode_attention host time a call: "
        f"{rows['decode_attention']['host_us']:.2f} us")

    # K2: one T=1 decode step of one layer at a prefix-sized frontier
    n = prefix_len + 64
    kc, vc = randn(L, 1, S, nkv, hd), randn(L, 1, S, nkv, hd)
    q1 = randn(1, nq, hd)
    kv_len = torch.tensor([n], dtype=torch.int32, device=dev)
    li = L - 1
    out = ops.decode_attention_layer(q1, kc, vc, kv_len, li)
    ref = decode_attention_reference(q1, kc[li], vc[li], kv_len)
    kh = kc[li, :, :n].transpose(1, 2).repeat_interleave(group, 1)
    vh = vc[li, :, :n].transpose(1, 2).repeat_interleave(group, 1)
    b_ms, b_by = bound(2 * (2 * nq * hd + 2 * n * nkv * hd), 4 * nq * hd * n)
    # the key range is split across blocks and merged in a fixed order: the
    # same bits from run to run
    fail_if(not torch.equal(out, ops.decode_attention_layer(q1, kc, vc, kv_len, li)),
            "decode_attention_layer: two calls on the same inputs differ")
    k2x = _k2_extra_operands(randn, dev, n)
    k2_pairs = [(out, ref)]
    for x in k2x.values():
        o2 = ops.decode_attention_layer(x["q"], x["k"], x["v"], x["kv_len"], 0)
        fail_if(not torch.equal(o2, ops.decode_attention_layer(x["q"], x["k"], x["v"],
                                                               x["kv_len"], 0)),
                f"decode_attention_layer ({x['label']}): two calls on the same inputs differ")
        fail_if(not bool((o2[x["kv_len"] == 0] == 0).all()),
                f"decode_attention_layer ({x['label']}): a row with kv_len 0 is not zeros")
        k2_pairs.append((o2, decode_attention_reference(x["q"], x["k"][0], x["v"][0],
                                                        x["kv_len"])))
    rows["decode_attention_layer"] = _kernel_row(
        "decode_attention_layer", *attn_err(k2_pairs), f"{ATTN_TOL} (bf16); {F32_TOL} (fp32)",
        cuda_ms(lambda: ops.decode_attention_layer(q1, kc, vc, kv_len, li), iters=100),
        cuda_ms(lambda: decode_attention_reference(q1, kc[li], vc[li], kv_len)),
        b_ms, b_by,
        cuda_ms(lambda: F.scaled_dot_product_attention(q1[:, :, None], kh, vh), iters=100))
    rows["decode_attention_layer"]["shape"] = (
        f"tinyllama-1.1b, 1 row at kv_len {n} of a (22, 1, 2048, 4, 64) bf16 cache; "
        + "; ".join(x["label"] for x in k2x.values()) + " checked")
    for key, x in k2x.items():
        if x["timed"]:
            rows["decode_attention_layer"][key] = _k2_extra_row(x)
    rows["decode_attention_layer"]["deterministic"] = True
    del k2x

    # K3: a fast-forward block [cur, chain...] padded with duplicates
    # (chain_block), here with a 5-token chain
    pos = torch.tensor([[n + min(i, 5) for i in range(9)]], dtype=torch.int32, device=dev)
    q9 = randn(1, 9, nq, hd)
    out = ops.decode_block_attention_layer(q9, kc, vc, pos, li)
    ref = decode_block_attention_reference(q9, kc[li], vc[li], pos)
    # unordered positions hold too
    perm = torch.tensor([[3, 8, 0, 5, 1, 7, 2, 6, 4]], device=dev)
    pos_u = torch.gather(pos, 1, perm)
    # the key range is split across blocks and merged in a fixed order: the
    # same bits from run to run
    fail_if(not torch.equal(out, ops.decode_block_attention_layer(q9, kc, vc, pos, li)),
            "decode_block_attention_layer: two calls on the same inputs differ")
    k3x = _k3_extra_operands(randn, dev, n)
    k3_err = attn_err([(out, ref),
                       (ops.decode_block_attention_layer(q9, kc, vc, pos_u, li),
                        decode_block_attention_reference(q9, kc[li], vc[li], pos_u)),
                       *[(ops.decode_block_attention_layer(x["q"], x["k"], x["v"], x["pos"], 0),
                          decode_block_attention_reference(x["q"], x["k"][0], x["v"][0],
                                                           x["pos"]))
                         for x in k3x.values()]])
    m = n + 6
    kh = kc[li, :, :m].transpose(1, 2).repeat_interleave(group, 1)
    vh = vc[li, :, :m].transpose(1, 2).repeat_interleave(group, 1)
    amask = torch.arange(m, device=dev)[None, :] <= pos[0][:, None]  # (9, m)
    b_ms, b_by = bound(2 * (2 * 9 * nq * hd + 2 * m * nkv * hd),
                       4 * nq * hd * float((pos + 1).sum()))
    rows["decode_block_attention_layer"] = _kernel_row(
        "decode_block_attention_layer", *k3_err, ATTN_TOL,
        cuda_ms(lambda: ops.decode_block_attention_layer(q9, kc, vc, pos, li), iters=100),
        cuda_ms(lambda: decode_block_attention_reference(q9, kc[li], vc[li], pos)),
        b_ms, b_by,
        cuda_ms(lambda: F.scaled_dot_product_attention(q9.transpose(1, 2), kh, vh,
                                                       attn_mask=amask), iters=100))
    # K3 at the dense verify step's shape: [cur, 4 drafts], all real
    pos5 = torch.tensor([[n + i for i in range(5)]], dtype=torch.int32, device=dev)
    q5b = randn(1, 5, nq, hd)
    m5 = n + 5
    kh5 = kc[li, :, :m5].transpose(1, 2).repeat_interleave(group, 1)
    vh5 = vc[li, :, :m5].transpose(1, 2).repeat_interleave(group, 1)
    amask5 = torch.arange(m5, device=dev)[None, :] <= pos5[0][:, None]
    rows["decode_block_attention_layer"]["verify"] = _extra_shape(
        "the (1, 5) speculative verify block at the same frontier",
        cuda_ms(lambda: ops.decode_block_attention_layer(q5b, kc, vc, pos5, li), iters=100),
        cuda_ms(lambda: decode_block_attention_reference(q5b, kc[li], vc[li], pos5)),
        *bound(2 * (2 * 5 * nq * hd + 2 * m5 * nkv * hd), 4 * nq * hd * float((pos5 + 1).sum())),
        cuda_ms(lambda: F.scaled_dot_product_attention(q5b.transpose(1, 2), kh5, vh5,
                                                       attn_mask=amask5), iters=100))
    for key, x in k3x.items():
        rows["decode_block_attention_layer"][key] = _k3_extra_row(x)
    rows["decode_block_attention_layer"]["deterministic"] = True
    del k3x

    # K12: K3's function on a flat (1, 2048, 4, 64) bf16 cache (the layer
    # plane above) at the same frontier, the (1, 5) verify block and the
    # (1, 9) chain block; and fp32 queries at the distilled checkpoint's
    # widths (4 q / 2 kv heads of 48) over a flat bf16 (2, 300) cache
    fk, fv = kc[li].contiguous(), vc[li].contiguous()
    q48 = randn(2, 5, 4, 48, dtype=torch.float32)
    k48, v48 = randn(2, 300, 2, 48), randn(2, 300, 2, 48)
    pos48 = torch.tensor([[120, 121, 122, 123, 124], [299, 3, 150, 150, 77]],
                         dtype=torch.int32, device=dev)
    k12_err = attn_err([
        (ops.decode_block_attention(q5b, fk, fv, pos5),
         decode_block_attention_reference(q5b, fk, fv, pos5)),
        (ops.decode_block_attention(q9, fk, fv, pos),
         decode_block_attention_reference(q9, fk, fv, pos)),
        (ops.decode_block_attention(q9, fk, fv, pos_u),
         decode_block_attention_reference(q9, fk, fv, pos_u)),
        (ops.decode_block_attention(q48, k48, v48, pos48),
         decode_block_attention_reference(q48, k48, v48, pos48))])
    rows["decode_block_attention"] = _kernel_row(
        "decode_block_attention", *k12_err, f"{ATTN_TOL} (bf16); {F32_TOL} (fp32, hd 48)",
        cuda_ms(lambda: ops.decode_block_attention(q5b, fk, fv, pos5), iters=100),
        cuda_ms(lambda: decode_block_attention_reference(q5b, fk, fv, pos5)),
        *bound(2 * (2 * 5 * nq * hd + 2 * m5 * nkv * hd), 4 * nq * hd * float((pos5 + 1).sum())),
        cuda_ms(lambda: F.scaled_dot_product_attention(q5b.transpose(1, 2), kh5, vh5,
                                                       attn_mask=amask5), iters=100))
    rows["decode_block_attention"]["shape"] = (
        f"a (1, 5) block at positions {n}-{n + 4} over a flat (1, 2048, 4, 64) bf16 cache; "
        "(1, 9) chain blocks and fp32 hd-48 queries checked")
    rows["decode_block_attention"]["chain"] = _extra_shape(
        "the (1, 9) chain block", cuda_ms(lambda: ops.decode_block_attention(q9, fk, fv, pos),
                                          iters=100),
        cuda_ms(lambda: decode_block_attention_reference(q9, fk, fv, pos)),
        *bound(2 * (2 * 9 * nq * hd + 2 * m * nkv * hd), 4 * nq * hd * float((pos + 1).sum())),
        cuda_ms(lambda: F.scaled_dot_product_attention(q9.transpose(1, 2), kh, vh,
                                                       attn_mask=amask), iters=100))

    rows.update(_paged_kernel_rows(g, randn))
    rows.update(_quant_kernel_rows(g, randn, n))
    _quant_moe_rows(g, randn, rows)
    rows.update(_gmm_kernel_rows(g))

    rows.update(_grammar_kernel_rows(fsm, g))
    torch.cuda.synchronize()
    return rows


# K1's log-sum-exp against the plain version's: both take the max of the
# same fp32 scores (summed in another order: ~1e-6 relative) and the log of
# a sum of up to 8192 exponentials (__expf within 2 ulp each), so an lse of
# ~10 may move by ~1e-5; a row that missed a key moves it by ~1e-4 / key
LSE_RTOL, LSE_ATOL = 1e-5, 2e-5
LSE_TOL = f"{LSE_RTOL:g}*|ref|+{LSE_ATOL:g}"
PLANNER_T = 8192  # the planner's largest context bucket at tinyllama-1.1b


def _k1_lse_shape(randn, dev) -> dict:
    """K1 with ``return_lse`` at the planner's cold start into its largest
    bucket, a shape of K1's row: causal T = 8192, tinyllama's 32/4 heads of
    64, bf16 (the bf16 output, and the fp32 output the ring merges) and
    fp32; output and lse against the plain version's. Library: SDPA's flash
    op, which returns the log-sum-exp too, on k/v expanded to 32 heads."""
    import torch

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import attention_reference

    T, nq, nkv, hd = PLANNER_T, 32, 4, 64
    q, k, v = randn(1, T, nq, hd), randn(1, T, nkv, hd), randn(1, T, nkv, hd)
    q32, k32, v32 = q.float(), k.float(), v.float()
    pairs, lse_pairs = [], []
    for args, out_dtype in (((q, k, v), None), ((q, k, v), torch.float32),
                            ((q32, k32, v32), None)):
        out, lse = ops.flash_attention(*args, causal=True, return_lse=True, out_dtype=out_dtype)
        ref, ref_lse = attention_reference(*args, causal=True, return_lse=True,
                                           out_dtype=out_dtype)
        fail_if(not torch.equal(out, ops.flash_attention(*args, causal=True,
                                                         out_dtype=out_dtype)),
                "flash_attention: the output with return_lse differs from the one without")
        pairs.append((out, ref))
        lse_pairs.append((lse, ref_lse))
        del ref
    out_abs, out_ratio = attn_err(pairs)
    lse_abs = max(float((a - b).abs().max()) for a, b in lse_pairs)
    lse_ratio = max(float(((a - b).abs() / (LSE_RTOL * b.abs() + LSE_ATOL)).max())
                    for a, b in lse_pairs)
    del pairs, lse_pairs
    torch.cuda.synchronize()
    log(f"[kernels]   flash_attention lse: max abs err {lse_abs:.3g} ({lse_ratio:.3g} of tol "
        f"{LSE_TOL})")
    pairs_n = T * (T + 1) / 2

    def nbytes(esz: int, osz: int) -> float:  # q, k, v read; out and lse written
        return esz * (T * nq * hd + 2 * T * nkv * hd) + osz * T * nq * hd + 4 * T * nq

    qh = q.transpose(1, 2)
    kh, vh = (x.transpose(1, 2).repeat_interleave(nq // nkv, 1) for x in (k, v))
    tol = f"out {ATTN_TOL} (bf16), {F32_TOL} (fp32 out); lse {LSE_TOL}"
    ratio = max(out_ratio, lse_ratio)
    fail_if(not ratio <= 1.0, f"flash_attention with lse: error {ratio:.3g}x its tolerance "
            f"{tol} (output max abs err {out_abs}, lse {lse_abs})")
    row = _extra_shape(
        "with the lse (B, T, nq) fp32, causal T = S = 8192, 32/4 heads of 64, bf16 "
        "(the fp32 output and fp32 operands checked)",
        cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True, return_lse=True), iters=5),
        cuda_ms(lambda: attention_reference(q, k, v, causal=True, return_lse=True), iters=2,
                warmup=1),
        *bound(nbytes(2, 2), 4 * nq * hd * pairs_n),
        cuda_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qh, kh, vh, 0.0, True), iters=5))
    row.update(max_abs_err=out_abs, tol=tol, err_over_tol=ratio, lse_max_abs_err=lse_abs,
               lse_err_over_tol=lse_ratio)
    row["fp32_out"] = _extra_shape(
        "bf16 operands, fp32 output (the ring's blocks)",
        cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True, return_lse=True,
                                            out_dtype=torch.float32), iters=5),
        cuda_ms(lambda: attention_reference(q, k, v, causal=True, return_lse=True,
                                            out_dtype=torch.float32), iters=2, warmup=1),
        *bound(nbytes(2, 4), 4 * nq * hd * pairs_n), None)
    row["fp32"] = _extra_shape(
        "fp32 operands and output (the fp32-activation twins)",
        cuda_ms(lambda: ops.flash_attention(q32, k32, v32, causal=True, return_lse=True),
                iters=3),
        cuda_ms(lambda: attention_reference(q32, k32, v32, causal=True, return_lse=True),
                iters=2, warmup=1),
        *bound(nbytes(4, 4), 4 * nq * hd * pairs_n, FP32_FLOPS), None)
    return row


# K4 / K11's whole-grammar sweep: rows a launch
SWEEP_ROWS = 4096


def _grammar_kernel_rows(fsm, g) -> dict:
    """K4 and K11 on the intent grammar's tables, exact (tolerance 0: every
    token id and next state equal to the plain version's): live and edge
    states, ties and dead states, then every state 0 .. S - 1 (``_argmax_sweep``).
    Timed at the path's shapes, K4 at B = 1 (the one-slot parse), 8 (the MoE
    drain) and 32 (the batch chunks), K11 at 5 and 160 rows (the (1, 5) and
    (32, 5) verify blocks): warm, the same states every launch; and cold,
    each launch the next (R,) slice of a seeded permutation of all the
    states after the L2 is flushed, so the states' mask and table rows come
    from HBM as a decoding row's new state's do. Beside them the launch
    floor (an in-place add on one element) and, where the package picks the
    rows a block (``argmax_geometry``), each choice timed."""
    import importlib
    import itertools

    import torch

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import masked_argmax_advance_reference, masked_argmax_reference

    dev = torch.device("cuda")
    tables = fsm.device_tables(device=dev)
    mk, tb, cid = tables.dense_mask, tables.table, tables.col_id
    S, V = fsm.num_states, fsm.vocab_size
    # live and edge states, random logits, a tied row
    states = torch.tensor([fsm.start, 5, 100, 1000, 20000, -1, 35000, 777],
                          dtype=torch.int32, device=dev)
    states = torch.clamp(states, max=S - 1)
    logits = torch.randn(states.shape[0], V, generator=g, device=dev)
    logits[3, :] = 0.25  # ties: the first legal index must win
    tok, nxt = ops.masked_argmax_advance(logits, states, mk, tb, cid)
    rtok, rnxt = masked_argmax_advance_reference(logits, states, mk, tb, cid)
    mismatch = int((tok != rtok).sum() + (nxt != rnxt).sum())

    # K11's verify blocks: states drawn from the grammar's with some dead (-1,
    # clamped to 0), a tied row
    def verify_rows(R: int, seed: int):
        gen = torch.Generator().manual_seed(seed)
        st = torch.randint(0, S, (R,), generator=gen, dtype=torch.int32)
        st[0] = fsm.start
        st[torch.randperm(R, generator=gen)[:max(1, R // 10)]] = -1
        lg = torch.randn(R, V, generator=gen)
        lg[R // 2] = 0.5
        return lg.to(dev), st.to(dev)

    mism, vrows = 0, {}
    for R in (5, 160):
        lg, st = verify_rows(R, R)
        blk = ops.masked_argmax_block(lg.reshape(R // 5, 5, V), st.reshape(R // 5, 5), mk)
        mism += int((blk.flatten() != masked_argmax_reference(lg, st, mk)).sum())
        vrows[R] = (lg, torch.clamp(st, min=0))  # what masked_argmax_block hands the kernel
    sweep = _argmax_sweep(tables, S, V)
    mismatch += sweep
    mism += sweep
    log(f"[kernels] K4 / K11 over all {S} states: {sweep} mismatches")
    torch.cuda.synchronize()

    perm = torch.randperm(S, generator=torch.Generator().manual_seed(12)).to(
        dev, torch.int32)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB > the 50 MB L2
    one = torch.zeros(1, device=dev)
    floor_ms = cuda_ms(lambda: one.add_(1), iters=200)
    log(f"[kernels] launch floor (an in-place add on one element): {floor_ms:.5f} ms")

    def k4(lg):
        return lambda st: ops.masked_argmax_advance(lg, st, mk, tb, cid)

    def k4_plain(lg):
        return lambda st: masked_argmax_advance_reference(lg, st, mk, tb, cid)

    def k11(lg):
        return lambda st: ops.masked_argmax(lg, st, mk)

    def k11_plain(lg):
        return lambda st: masked_argmax_reference(lg, st, mk)

    def warm_ms(fn, st, iters=200):
        return cuda_ms(lambda: fn(st), iters=iters)

    def cold_ms(fn, R, iters=200):
        """Each launch the next (R,) slice of ``perm``, no slice twice in a
        run, after the L2 is flushed."""
        iters = min(iters, (S // R - 3) // 2)
        slices = itertools.cycle([perm[i:i + R] for i in range(0, S - R + 1, R)])
        flush.fill_(0)
        return cuda_ms(lambda: fn(next(slices)), iters=iters)

    def k4_bound(B):
        # a row: V logits (4 B) + its V-byte mask row + state, table entry and
        # col_id entry in, token and state out; V compares
        return bound(B * (V * 4 + V + 3 * 4 + 2 * 4), B * V, FP32_FLOPS)

    def k11_bound(R):
        # R rows of V logits (4 B) and V mask bytes, a state in, a token out
        return bound(R * V * 5 + 2 * 4 * R, R * V, FP32_FLOPS)

    lg32 = torch.randn(32, V, generator=g, device=dev)
    lgs = {1: logits[:1].contiguous(), 8: lg32[:8].contiguous(), 32: lg32}
    fixed = {1: states[:1].contiguous(), 8: perm[:8].contiguous(), 32: perm[:32].contiguous()}
    rows = {"masked_argmax_advance": _kernel_row(
        "masked_argmax_advance", float(mismatch), float(mismatch > 0), 0.0,
        warm_ms(k4(lgs[1]), fixed[1]), warm_ms(k4_plain(lgs[1]), fixed[1], iters=20),
        *k4_bound(1), None)}
    k4row = rows["masked_argmax_advance"]
    k4row["shape"] = (f"B rows of V {V} fp32 logits over the intent grammar's ({S}, {V}) mask "
                      f"and ({S}, {tb.shape[1]}) table: B = 1 warm at the start state (ms); "
                      "B = 8 and 32 warm, and B = 1, 8, 32 cold; all states checked")
    for B in (1, 8, 32):
        if B > 1:
            k4row[f"b{B}"] = _extra_shape(
                f"B = {B}, warm", warm_ms(k4(lgs[B]), fixed[B]),
                warm_ms(k4_plain(lgs[B]), fixed[B], iters=20), *k4_bound(B), None)
        k4row[f"cold_b{B}"] = _extra_shape(
            f"B = {B}, cold", cold_ms(k4(lgs[B]), B), cold_ms(k4_plain(lgs[B]), B, iters=20),
            *k4_bound(B), None)
    lg5, st5 = vrows[5]
    lg160, st160 = vrows[160]
    rows["masked_argmax"] = _kernel_row(
        "masked_argmax", float(mism), float(mism > 0), 0.0, warm_ms(k11(lg5), st5),
        warm_ms(k11_plain(lg5), st5, iters=20), *k11_bound(5), None)
    k11row = rows["masked_argmax"]
    k11row["shape"] = (f"the (1, 5) verify block: 5 rows of V {V} fp32 logits and the (S, V) "
                       "grammar mask, warm (ms); 160 rows warm, 5 and 160 cold; all states "
                       "checked")
    k11row["batch"] = _extra_shape("the (32, 5) verify block: 160 rows",
                                   warm_ms(k11(lg160), st160),
                                   warm_ms(k11_plain(lg160), st160, iters=20),
                                   *k11_bound(160), None)
    for R, lg in ((5, lg5), (160, lg160)):
        k11row[f"cold_r{R}"] = _extra_shape(f"{R} rows, cold", cold_ms(k11(lg), R),
                                            cold_ms(k11_plain(lg), R, iters=20),
                                            *k11_bound(R), None)
    k4row["launch_floor_ms"] = k11row["launch_floor_ms"] = floor_ms

    gm = importlib.import_module("tpu_voice_agent_torch.ops.grammar_mask")
    picked = getattr(gm, "argmax_geometry", None)
    if picked is not None:  # the warp-a-row body: time each rows-a-block choice
        sweep_ms = {}
        try:
            for rpb in (1, 2, 4, 8):
                gm.argmax_geometry = lambda R, V, rpb=rpb: (rpb, picked(R, V)[1])
                for label, fn, st, R in (("k4_b8", k4(lgs[8]), fixed[8], 8),
                                         ("k4_b32", k4(lgs[32]), fixed[32], 32),
                                         ("k11_r5", k11(lg5), st5, 5),
                                         ("k11_r160", k11(lg160), st160, 160)):
                    sweep_ms[f"{label}_rows{rpb}"] = (warm_ms(fn, st), cold_ms(fn, R))
        finally:
            gm.argmax_geometry = picked
        k4row["rows_per_block_ms"] = {k: v for k, v in sweep_ms.items() if k.startswith("k4")}
        k11row["rows_per_block_ms"] = {k: v for k, v in sweep_ms.items()
                                       if k.startswith("k11")}
        log("[kernels]   rows a block (warm, cold ms): " + ", ".join(
            f"{k} {w:.5f} {c:.5f}" for k, (w, c) in sweep_ms.items()))
    return rows


def _argmax_sweep(tables, S: int, V: int) -> int:
    """K4 and K11 over every state 0 .. S - 1 in chunks of ``SWEEP_ROWS``
    rows, seeded logits, per chunk a tied row (first legal index) and a NaN
    row: the number of tokens and next states that differ from the plain
    versions' outside the NaN rows (whose picks must lie in range). The last
    state's mask row ends its allocation: an overrun shows there as a
    mismatch or a fault."""
    import torch

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import masked_argmax_advance_reference

    dev = tables.table.device
    gen = torch.Generator(device=dev).manual_seed(4)
    bad = 0
    for lo in range(0, S, SWEEP_ROWS):
        st = torch.arange(lo, min(lo + SWEEP_ROWS, S), dtype=torch.int32, device=dev)
        n = st.numel()
        lg = torch.randn(n, V, generator=gen, device=dev)
        lg[0] = 0.5
        lg[n // 2, ::3] = float("nan")
        keep = torch.arange(n, device=dev) != n // 2
        tok, nxt = ops.masked_argmax_advance(lg, st, tables.dense_mask, tables.table,
                                             tables.col_id)
        tok11 = ops.masked_argmax(lg, st, tables.dense_mask)
        rtok, rnxt = masked_argmax_advance_reference(lg, st, tables.dense_mask, tables.table,
                                                     tables.col_id)
        bad += int(((tok != rtok) | (nxt != rnxt) | (tok11 != rtok))[keep].sum())
        for t in (tok, tok11):
            fail_if(not 0 <= int(t[n // 2]) < V, f"a NaN row's pick {int(t[n // 2])} is out "
                    f"of range")
    torch.cuda.synchronize()
    return bad


def _k5_batched_row(randn, dev) -> dict:
    """K5 at the batched STT plane's cross-attention (``serve/stt_batch.py``,
    STT_BATCH_SLOTS = 4): B = 4 rows over the padded 1500-position pool,
    kv_len (1500, 1000, 500, 0), every position past a row's kv_len NaN (a
    stale slot's earlier utterance, a dead row's garbage). The kernel and its
    plain version must agree, equal the kernel on the same inputs without the
    NaN bit for bit, stay finite, and give the kv_len 0 row zeros. The bound
    counts the live keys: 3,000 positions of K and V at 20 heads of 64."""
    import torch
    import torch.nn.functional as F

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import decode_attention_reference

    B, S, nh, hd = 4, 1500, 20, 64
    k, v, q = randn(B, S, nh, hd), randn(B, S, nh, hd), randn(B, nh, hd)
    lens = [1500, 1000, 500, 0]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    clean = ops.decode_attention(q, k, v, kv_len)
    kp, vp = k.clone(), v.clone()
    for b, n in enumerate(lens):
        kp[b, n:] = float("nan")
        vp[b, n:] = float("nan")
    out = ops.decode_attention(q, kp, vp, kv_len)
    ref = decode_attention_reference(q, kp, vp, kv_len)
    fail_if(not bool(torch.isfinite(out).all()), "decode_attention (batched): NaN in the sum")
    fail_if(not torch.equal(out, clean),
            "decode_attention (batched): NaN past kv_len changed the output")
    fail_if(not bool((out[3] == 0).all()), "decode_attention (batched): kv_len 0 is not zeros")
    err, ratio = attn_err([(out, ref)])
    fail_if(not ratio <= 1.0, f"decode_attention (batched): error {ratio:.3g}x its tolerance "
            f"{ATTN_TOL} (max abs err {err})")
    live = sum(lens)
    mask = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    row = _extra_shape(
        "batched STT plane cross-attention, B = 4 over the 1500-position pool, kv_len "
        "(1500, 1000, 500, 0), NaN past each kv_len, 20 heads, hd 64, bf16",
        cuda_ms(lambda: ops.decode_attention(q, kp, vp, kv_len), iters=100),
        cuda_ms(lambda: decode_attention_reference(q, kp, vp, kv_len)),
        *bound(2 * (2 * B * nh * hd + 2 * live * nh * hd) + 4 * B, 4 * nh * hd * live),
        cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kh, vh, attn_mask=mask),
                iters=100))
    row.update(max_abs_err=err, err_over_tol=ratio, tol=ATTN_TOL)
    log(f"[kernels]   decode_attention (batched): max_abs_err {err:.3g} ({ratio:.3g} of tol), "
        "NaN-poisoned stale positions left out, kv_len 0 zeros")
    return row


def _host_us(fn, iters: int = 500) -> float:
    """Mean host time of ``fn()`` a call over ``iters`` back-to-back calls
    whose kernels take less device time than their launches take host time
    (the queue never fills), so the wall is the host's."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _one_key_set_ms(cases: dict) -> dict:
    """K5 timed with one warp set a split (one query row per warp, K2's
    instantiation: the split body without warps on keys), beside the key
    sets the wrapper picks, at Whisper's shapes; the outputs of both are
    held to the plain version in the kernels phase's tolerance."""
    import importlib

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import decode_attention_reference

    da = importlib.import_module("tpu_voice_agent_torch.ops.decode_attention")
    picked, out = getattr(da, "key_sets", None), {}
    if picked is None:  # an earlier checkout of the package: one body only
        return out
    da.key_sets = lambda *a: 1
    try:
        for label, args in cases.items():
            _, ratio = attn_err([(ops.decode_attention(*args), decode_attention_reference(*args))])
            fail_if(not ratio <= 1.0, f"decode_attention ({label}, one key set): error {ratio:.3g}x "
                    "its tolerance")
            out[label] = cuda_ms(lambda: ops.decode_attention(*args), iters=100)
    finally:
        da.key_sets = picked
    log("[kernels]   decode_attention with one key set: " + ", ".join(
        f"{label} {ms:.5f} ms" for label, ms in out.items()))
    return out


def phase_digest(report: dict) -> dict:
    """SHA-256 of the outputs of the kernels whose bodies a redesign of
    another kernel must leave as they are, on seeded inputs at the main
    path's shapes: K5 (large-v3's cross-attention in bf16, the checkpoints'
    fp32 hd-16 cache), K3 (tinyllama's (1, 9) chain block), K1 (a causal
    bf16 prefix block, the checkpoints' fp32 encoder block), K2 (tinyllama's
    T = 1 step at frontier 943), and over a paged pool with a shared prefix
    K6 and K8 (int8, int4) at T = 1 and K7 / K9 on a (4, 9) fast-forward
    block, each with bf16 and with fp32 queries. The same digests from two
    builds mean the same bits. K5's, and K6's to K9's bf16 outputs (their
    split bodies), must be the same from two calls. Only wrappers with the same
    signature in every slice are called, so the script runs against an
    earlier checkout of the package too."""
    import hashlib

    import torch

    from tpu_voice_agent_torch import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    def digest(t) -> str:
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()

    q5, k5, v5 = randn(1, 20, 64), randn(1, 500, 20, 64), randn(1, 500, 20, 64)
    f32 = torch.float32
    q16, k16, v16 = randn(2, 4, 16, dtype=f32), randn(2, 100, 4, 16, dtype=f32), randn(
        2, 100, 4, 16, dtype=f32)
    kc, vc = randn(2, 1, 2048, 4, 64), randn(2, 1, 2048, 4, 64)
    q9 = randn(1, 9, 32, 64)
    pos = torch.tensor([[943 + min(i, 5) for i in range(9)]], dtype=torch.int32, device=dev)
    out = {
        "decode_attention bf16": digest(ops.decode_attention(
            q5, k5, v5, torch.tensor([500], dtype=torch.int32, device=dev))),
        "decode_attention fp32": digest(ops.decode_attention(
            q16, k16, v16, torch.tensor([37, 100], dtype=torch.int32, device=dev))),
        "decode_block_attention_layer (1, 9)": digest(
            ops.decode_block_attention_layer(q9, kc, vc, pos, 1)),
        "flash_attention bf16 causal": digest(ops.flash_attention(
            randn(1, 256, 32, 64), randn(1, 256, 4, 64), randn(1, 256, 4, 64), causal=True)),
        "flash_attention fp32": digest(ops.flash_attention(
            *(randn(1, 100, 4, 16, dtype=torch.float32) for _ in range(3)), causal=False)),
    }
    for key, args in (("decode_attention bf16", (q5, k5, v5, torch.tensor(
            [500], dtype=torch.int32, device=dev))), ("decode_attention fp32", (
            q16, k16, v16, torch.tensor([37, 100], dtype=torch.int32, device=dev)))):
        fail_if(digest(ops.decode_attention(*args)) != out[key],
                f"digest: {key} differs between two calls")
    q1 = randn(1, 32, 64)
    out["decode_attention_layer T = 1"] = digest(ops.decode_attention_layer(
        q1, kc, vc, torch.tensor([944], dtype=torch.int32, device=dev), 1))
    lens = [900, 944, 1000, 1050]
    tables, n_blocks = _paged_tables(g, 4, 6, lens, 128, 16)
    kp, vp = randn(2, n_blocks, 128, 4, 64), randn(2, n_blocks, 128, 4, 64)
    qpos = torch.tensor([[n - 10 + min(i, c) for i in range(9)] for n, c in
                         zip(lens, (0, 3, 5, 8))], dtype=torch.int32, device=dev)
    q9p = randn(4, 9, 32, 64)
    out["paged_block_attention (4, 9)"] = digest(ops.paged_block_attention(
        q9p, kp, vp, tables, qpos, 1))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q1p = randn(4, 32, 64)
    out["paged_attention fp32 (4,)"] = digest(ops.paged_attention(
        q1p.float(), kp, vp, tables, kv_len, 1))
    out["paged_block_attention fp32 (4, 9)"] = digest(ops.paged_block_attention(
        q9p.float(), kp, vp, tables, qpos, 1))
    twice = {"paged_block_attention (4, 9)": lambda: ops.paged_block_attention(
        q9p, kp, vp, tables, qpos, 1),
        "paged_attention (4,)": lambda: ops.paged_attention(q1p, kp, vp, tables, kv_len, 1)}
    out["paged_attention (4,)"] = digest(twice["paged_attention (4,)"]())
    for tier, bits in (("int8", 8), ("int4", 4)):
        kq, ks = _quant_values(g, (2, n_blocks, 128, 4, 64), tier)
        vq, vs = _quant_values(g, (2, n_blocks, 128, 4, 64), tier)
        key = f"paged_attention_quant {tier} (4,)"
        twice[key] = (lambda kq=kq, vq=vq, ks=ks, vs=vs, bits=bits:
                      ops.paged_attention_quant(q1p, kq, vq, ks, vs, tables, kv_len, 1,
                                                bits=bits))
        out[key] = digest(twice[key]())
        out[f"paged_attention_quant {tier} fp32 (4,)"] = digest(ops.paged_attention_quant(
            q1p.float(), kq, vq, ks, vs, tables, kv_len, 1, bits=bits))
        out[f"paged_block_attention_quant {tier} fp32 (4, 9)"] = digest(
            ops.paged_block_attention_quant(q9p.float(), kq, vq, ks, vs, tables, qpos, 1,
                                            bits=bits))
        key = f"paged_block_attention_quant {tier} (4, 9)"
        twice[key] = (lambda kq=kq, vq=vq, ks=ks, vs=vs, bits=bits:
                      ops.paged_block_attention_quant(q9p, kq, vq, ks, vs, tables, qpos, 1,
                                                      bits=bits))
        out[key] = digest(twice[key]())
    for key, fn in twice.items():
        fail_if(digest(fn()) != out[key], f"digest: {key} differs between two calls")
    for key, d in out.items():
        log(f"[digest] {key}: {d}")
    report["digest"] = out
    return out


def _k2_extra_operands(randn, dev, n: int) -> dict:
    """K2 at the other shapes it serves, each a one-layer (1, B, 2048, nkv,
    hd) bf16 cache: mixtral-8x7b's decode step (32/8 heads of 128); the dense
    batcher's 8 rows at ragged kv_len, one at 0 (zeros), one ending mid-tile;
    fp32 queries at the distilled checkpoint's widths (4/2 heads of 48).
    ``timed``: the path's shapes, timed beside the plain version and SDPA."""
    import torch

    S = 2048

    def operands(label, B, nq, nkv, hd, kv_len, timed, qdtype=torch.bfloat16,
                 kvdtype=torch.bfloat16, S=S):
        return {"label": label, "q": randn(B, nq, hd, dtype=qdtype),
                "k": randn(1, B, S, nkv, hd, dtype=kvdtype),
                "v": randn(1, B, S, nkv, hd, dtype=kvdtype),
                "kv_len": torch.tensor(kv_len, dtype=torch.int32, device=dev), "timed": timed}

    lens = [0, 37, 300, 511, 700, n, 1500, 2048]
    return {
        "mixtral": operands(f"mixtral-8x7b decode step, 32/8 heads of 128, kv_len {n}", 1, 32,
                            8, 128, [n], True),
        "batch": operands(f"the dense batcher's 8 rows, kv_len {lens}", 8, 32, 4, 64, lens, True),
        "fp32": operands("fp32 queries at the distilled widths, 2 rows, 4/2 heads of 48, "
                         "kv_len [0, 77]", 2, 4, 2, 48, [0, 77], False, torch.float32),
        # the planner-distilled decode step: the planner keeps its cache in
        # the activations' type, fp32 on the distilled checkpoint
        "fp32kv": operands("planner-distilled's step: fp32 queries over an fp32 (1, 512, 2, 48) "
                           "cache, 4/2 heads, kv_len 300", 1, 4, 2, 48, [300], True,
                           torch.float32, torch.float32, 512),
    }


def _k2_extra_row(x: dict) -> dict:
    """Time K2 at one of ``_k2_extra_operands``'s shapes beside its plain
    version and SDPA (each row's keys masked at its kv_len, the GQA heads
    repeated)."""
    import torch
    import torch.nn.functional as F

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import decode_attention_reference

    q, k, v, kv_len = x["q"], x["k"], x["v"], x["kv_len"]
    B, nq, hd = q.shape
    nkv = k.shape[3]
    m = int(kv_len.max())
    kh = k[0, :, :m].transpose(1, 2).repeat_interleave(nq // nkv, 1)
    vh = v[0, :, :m].transpose(1, 2).repeat_interleave(nq // nkv, 1)
    amask = (torch.arange(m, device=q.device)[None, :] < kv_len[:, None])[:, None, None, :]
    qh = q[:, :, None]
    kv_bytes = 2 * k.element_size() * float(kv_len.sum()) * nkv * hd
    return _extra_shape(
        x["label"],
        cuda_ms(lambda: ops.decode_attention_layer(q, k, v, kv_len, 0), iters=100),
        cuda_ms(lambda: decode_attention_reference(q, k[0], v[0], kv_len)),
        *bound(2 * q.element_size() * q.numel() + kv_bytes + 4 * B,
               4 * nq * hd * float(kv_len.sum())),
        cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask), iters=100))


def _k3_extra_operands(randn, dev, n: int) -> dict:
    """K3 at the other shapes it serves, each a one-layer (1, B, 2048, nkv,
    hd) bf16 cache: mixtral-8x7b's (1, 9) chain block (32/8 heads of 128);
    the dense batcher's (8, 9) blocks, one row per frontier with row 0 idle
    at frontier 0; the widest block (T = 16, a group of 16); fp32 queries
    at the distilled checkpoint's widths (4/2 heads of 48), a (2, 5) verify
    block."""
    import torch

    S = 2048

    def chain(front: int, T: int = 9, chain_len: int = 5):
        return [front + min(i, chain_len) for i in range(T)]

    def operands(label, B, T, nq, nkv, hd, pos, qdtype=torch.bfloat16, kvdtype=torch.bfloat16):
        return {"label": label, "q": randn(B, T, nq, hd, dtype=qdtype),
                "k": randn(1, B, S, nkv, hd, dtype=kvdtype),
                "v": randn(1, B, S, nkv, hd, dtype=kvdtype),
                "pos": torch.tensor(pos, dtype=torch.int32, device=dev)}

    fronts = [0, 37, 300, 511, 700, n, 1500, 2030]
    return {
        "mixtral": operands("mixtral-8x7b (1, 9) chain block, 32/8 heads, hd 128, frontier "
                            f"{n}", 1, 9, 32, 8, 128, [chain(n)]),
        "batch": operands(f"the dense batcher's (8, 9) blocks, frontiers {fronts}", 8, 9, 32, 4,
                          64, [[0] * 9] + [chain(f) for f in fronts[1:]]),
        "widest": operands(f"the widest block: T = 16, 32/2 heads (group 16), frontier {n}", 1,
                           16, 32, 2, 64, [[n + i for i in range(16)]]),
        "fp32": operands("fp32 queries at the distilled widths, (2, 5), 4/2 heads of 48", 2, 5,
                         4, 2, 48, [[120, 121, 122, 123, 124], [299, 3, 150, 150, 77]],
                         torch.float32),
        "fp32kv": operands("fp32 queries over an fp32 cache (a planner on fp32 weights at ff > 0), "
                           "(1, 9), 4/2 heads of 48", 1, 9, 4, 2, 48, [chain(300)],
                           torch.float32, torch.float32),
    }


def _k3_extra_row(x: dict) -> dict:
    """Time K3 at one of ``_k3_extra_operands``'s shapes beside its plain
    version and SDPA (each row's mask over the keys up to the largest
    frontier, the GQA heads repeated)."""
    import torch
    import torch.nn.functional as F

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import decode_block_attention_reference

    q, k, v, pos = x["q"], x["k"], x["v"], x["pos"]
    B, T, nq, hd = q.shape
    nkv = k.shape[3]
    m = int(pos.max()) + 1
    kh = k[0, :, :m].transpose(1, 2).repeat_interleave(nq // nkv, 1).to(q.dtype)
    vh = v[0, :, :m].transpose(1, 2).repeat_interleave(nq // nkv, 1).to(q.dtype)
    amask = (torch.arange(m, device=q.device)[None, None, :] <= pos[:, :, None])[:, None]
    qh = q.transpose(1, 2)
    kv_bytes = 2 * k.element_size() * float((pos.max(dim=1).values + 1).sum()) * nkv * hd
    return _extra_shape(
        x["label"], cuda_ms(lambda: ops.decode_block_attention_layer(q, k, v, pos, 0), iters=100),
        cuda_ms(lambda: decode_block_attention_reference(q, k[0], v[0], pos)),
        *bound(2 * q.element_size() * q.numel() + kv_bytes + 4 * pos.numel(),
               4 * nq * hd * float((pos + 1).sum())),
        cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask), iters=100))


def _paged_tables(g, B: int, prefix_blocks: int, kv_len, bs: int, max_blocks: int):
    """Block tables as the paged engine lays them out: every row shares the
    prefix's blocks 1..prefix_blocks, then owns enough blocks (handed out
    in a shuffled order) to cover its kv_len; unused entries hold 0."""
    import torch

    own = [-(-int(n) // bs) - prefix_blocks for n in kv_len]
    n_blocks = 1 + prefix_blocks + sum(own)
    ids = (torch.randperm(sum(own), generator=torch.Generator().manual_seed(B + bs))
           + 1 + prefix_blocks).tolist()
    tables = torch.zeros((B, max_blocks), dtype=torch.int32)
    for b in range(B):
        row = list(range(1, 1 + prefix_blocks)) + ids[:own[b]]
        ids = ids[own[b]:]
        tables[b, :len(row)] = torch.tensor(row, dtype=torch.int32)
    return tables.to(g.device), n_blocks


def _paged_kernel_rows(g, randn) -> dict:
    """K6 and K7 at the batch phase's shapes: 32 rows over the full-width
    pool (22 layers, 513 blocks of 128, 4 kv heads of 64, bf16), the cached
    prefix's 6 full blocks shared by every row, ragged kv_len 900-1050 for
    K6; K7 a (32, 9) fast-forward block per row with its own chain length
    (positions padded with duplicates, as chain_block pads them), also the
    (32, 5) spec verify block, mixtral-8x7b's (8, 9) drain block and T = 1
    step (``_paged_moe_row``) and one split a (row, kv head)
    (``one_split_ms``); K6 also with rows at kv_len 0, 1 and off the 64-key
    tiles, and two calls bit-equal.
    Also block sizes 16, 32 and 64 on a 2-layer pool. The library yardstick
    is SDPA on a pre-gathered contiguous copy (the gather is not timed)."""
    import torch
    import torch.nn.functional as F

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import (
        paged_attention_reference,
        paged_block_attention_reference,
    )
    from tpu_voice_agent_torch.ops.paged_attention import gather_pages

    dev = torch.device("cuda")
    L, N, bs, nq, nkv, hd, B = 22, 513, 128, 32, 4, 64, 32
    group, li = nq // nkv, L - 1
    kp, vp = randn(L, N, bs, nkv, hd), randn(L, N, bs, nkv, hd)
    lens = torch.randint(900, 1051, (B,), generator=torch.Generator().manual_seed(3))
    tables, _ = _paged_tables(g, B, 6, lens, bs, 16)
    kv_len = lens.to(torch.int32).to(dev)
    q = randn(B, nq, hd)
    chain = torch.randint(0, 9, (B,), generator=torch.Generator().manual_seed(4)).to(dev)
    iw = torch.arange(9, device=dev)[None, :]
    qpos = (kv_len[:, None] - 10 + torch.minimum(iw, chain[:, None])).to(torch.int32)
    q9 = randn(B, 9, nq, hd)
    pairs6 = [(ops.paged_attention(q, kp, vp, tables, kv_len, li),
               paged_attention_reference(q, kp, vp, tables, kv_len, li))]
    # rows at kv_len 0 (zeros), 1, and lengths off the 64-key tiles
    kz = kv_len.clone()
    kz[:4] = torch.tensor([0, 1, 77, 129], dtype=torch.int32)
    pairs6.append((ops.paged_attention(q, kp, vp, tables, kz, li),
                   paged_attention_reference(q, kp, vp, tables, kz, li)))
    fail_if(not bool((pairs6[-1][0][0] == 0).all()), "paged_attention: a kv_len-0 row is not "
            "zeros")
    pairs7 = [(ops.paged_block_attention(q9, kp, vp, tables, qpos, li),
               paged_block_attention_reference(q9, kp, vp, tables, qpos, li))]
    for sbs in (16, 32, 64):
        mb = -(-1100 // sbs)
        t_s, n_s = _paged_tables(g, B, 768 // sbs, lens, sbs, mb)
        ks, vs = randn(2, n_s, sbs, nkv, hd), randn(2, n_s, sbs, nkv, hd)
        pairs6.append((ops.paged_attention(q, ks, vs, t_s, kv_len, 1),
                       paged_attention_reference(q, ks, vs, t_s, kv_len, 1)))
        pairs7.append((ops.paged_block_attention(q9, ks, vs, t_s, qpos, 1),
                       paged_block_attention_reference(q9, ks, vs, t_s, qpos, 1)))
    torch.cuda.synchronize()

    # library yardstick inputs: each row's blocks gathered, GQA heads repeated
    S = tables.shape[1] * bs
    kh = gather_pages(kp, tables, li).transpose(1, 2).repeat_interleave(group, 1)
    vh = gather_pages(vp, tables, li).transpose(1, 2).repeat_interleave(group, 1)
    s_idx = torch.arange(S, device=dev)
    mask6 = (s_idx[None, :] < kv_len[:, None])[:, None, None, :]
    mask7 = (s_idx[None, None, :] <= qpos[:, :, None])[:, None]
    kv_row = 2 * nkv * hd * 2  # K and V bytes per key position (bf16)
    shared = 6 * bs  # prefix positions every row reads
    uniq6 = shared + float((kv_len - shared).sum())
    per_row6 = float(kv_len.sum())
    io6 = 2 * 2 * B * nq * hd + 4 * B + 4 * tables.numel()
    b6 = bound(io6 + uniq6 * kv_row, 4 * nq * hd * per_row6)
    keys7 = qpos.amax(dim=1) + 1
    uniq7 = shared + float((keys7 - shared).sum())
    io7 = 2 * 2 * B * 9 * nq * hd + 4 * qpos.numel() + 4 * tables.numel()
    b7 = bound(io7 + uniq7 * kv_row, 4 * nq * hd * float((qpos + 1).sum()))
    rows = {}
    rows["paged_attention"] = _kernel_row(
        "paged_attention", *attn_err(pairs6), ATTN_TOL,
        cuda_ms(lambda: ops.paged_attention(q, kp, vp, tables, kv_len, li), iters=100),
        cuda_ms(lambda: paged_attention_reference(q, kp, vp, tables, kv_len, li)),
        *b6,
        cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kh, vh,
                                                       attn_mask=mask6), iters=100))
    rows["paged_attention"]["bound_ms_prefix_per_row"] = bound(
        io6 + per_row6 * kv_row, 4 * nq * hd * per_row6)[0]
    rows["paged_attention"]["shape"] = (
        "B 32, pool (22, 513, 128, 4, 64) bf16, 6 shared prefix blocks, kv_len "
        f"{int(kv_len.min())}-{int(kv_len.max())}; bs 16/32/64 checked on a 2-layer pool, "
        "and rows at kv_len 0, 1, 77, 129")
    # bf16 queries run the split body, merged in a fixed order: the same bits
    # from run to run
    fail_if(not torch.equal(pairs6[0][0], ops.paged_attention(q, kp, vp, tables, kv_len, li)),
            "paged_attention: two calls on the same inputs differ")
    rows["paged_attention"]["deterministic"] = True
    k6 = lambda: ops.paged_attention(q, kp, vp, tables, kv_len, li)
    rows["paged_attention"]["one_split_ms"] = _one_split_ms(k6, pairs6[0][1], "paged_t1_chunk")
    rows["paged_block_attention"] = _kernel_row(
        "paged_block_attention", *attn_err(pairs7), ATTN_TOL,
        cuda_ms(lambda: ops.paged_block_attention(q9, kp, vp, tables, qpos, li), iters=100),
        cuda_ms(lambda: paged_block_attention_reference(q9, kp, vp, tables, qpos, li)),
        *b7,
        cuda_ms(lambda: F.scaled_dot_product_attention(q9.transpose(1, 2), kh, vh,
                                                       attn_mask=mask7), iters=100))
    rows["paged_block_attention"]["bound_ms_prefix_per_row"] = bound(
        io7 + float(keys7.sum()) * kv_row, 4 * nq * hd * float((qpos + 1).sum()))[0]
    rows["paged_block_attention"]["shape"] = (
        "(32, 9) blocks, chains of 0-8 padded with duplicates, over the same pool and tables")
    # bf16 queries run the split body, merged in a fixed order: the same bits
    # from run to run
    fail_if(not torch.equal(pairs7[0][0], ops.paged_block_attention(q9, kp, vp, tables, qpos, li)),
            "paged_block_attention: two calls on the same inputs differ")
    rows["paged_block_attention"]["deterministic"] = True
    # the spec verify step: [cur, 4 drafts] over the same pool
    q5, qpos5 = q9[:, :5].contiguous(), (kv_len[:, None] - 5 + iw[:, :5]).to(torch.int32)
    mask5 = (s_idx[None, None, :] <= qpos5[:, :, None])[:, None]
    keys5 = qpos5.amax(dim=1) + 1
    rows["paged_block_attention"]["spec"] = _extra_shape(
        "the (32, 5) spec verify block over the same pool",
        cuda_ms(lambda: ops.paged_block_attention(q5, kp, vp, tables, qpos5, li), iters=100),
        cuda_ms(lambda: paged_block_attention_reference(q5, kp, vp, tables, qpos5, li)),
        *bound(2 * 2 * B * 5 * nq * hd + 4 * qpos5.numel() + 4 * tables.numel()
               + (shared + float((keys5 - shared).sum())) * kv_row,
               4 * nq * hd * float((qpos5 + 1).sum())),
        cuda_ms(lambda: F.scaled_dot_product_attention(q5.transpose(1, 2), kh, vh,
                                                       attn_mask=mask5), iters=100))
    extra = [attn_err([(ops.paged_block_attention(q5, kp, vp, tables, qpos5, li),
                        paged_block_attention_reference(q5, kp, vp, tables, qpos5, li))])]
    rows["paged_block_attention"]["one_split_ms"] = _one_split_ms(
        lambda: ops.paged_block_attention(q9, kp, vp, tables, qpos, li), pairs7[0][1])
    del kp, vp, kh, vh
    moe7, moe6, moe_err, moe_err6 = _paged_moe_row(g, randn, lens)
    rows["paged_block_attention"]["mixtral"], rows["paged_attention"]["mixtral"] = moe7, moe6
    extra.append(moe_err)
    fail_if(not moe_err6[1] <= 1.0, f"paged_attention (mixtral-8x7b): error {moe_err6[1]:.3g}x "
            f"its tolerance {ATTN_TOL}")
    k6r = rows["paged_attention"]
    k6r["max_abs_err"], k6r["err_over_tol"] = (max(k6r["max_abs_err"], moe_err6[0]),
                                               max(k6r["err_over_tol"], moe_err6[1]))
    k7 = rows["paged_block_attention"]
    for err, ratio in extra:
        fail_if(not ratio <= 1.0, f"paged_block_attention: error {ratio:.3g}x its tolerance "
                f"{ATTN_TOL} (max abs err {err})")
        k7["max_abs_err"], k7["err_over_tol"] = (max(k7["max_abs_err"], err),
                                                 max(k7["err_over_tol"], ratio))
    return rows


def _one_split_ms(fn, ref, picker: str = "paged_key_chunk") -> float | None:
    """K7 / K9 (``picker`` paged_key_chunk) or K6 / K8 (paged_t1_chunk)
    timed with one split a (batch row, kv head), the whole key range in one
    block, beside the split body's chunks: what splitting the keys across
    the card buys. The output is held to the plain version."""
    import importlib

    pa = importlib.import_module("tpu_voice_agent_torch.ops.paged_attention")
    picked = getattr(pa, picker, None)
    if picked is None:  # an earlier checkout of the package: one body only
        return None
    setattr(pa, picker, lambda B, S, nkv, *rest: -(-S // 128) * 128)
    pa._paged_plan.cache_clear()
    try:
        _, ratio = attn_err([(fn(), ref)])
        fail_if(not ratio <= 1.0, f"one split: error {ratio:.3g}x its tolerance")
        ms = cuda_ms(fn, iters=100)
    finally:
        setattr(pa, picker, picked)
        pa._paged_plan.cache_clear()
    log(f"[kernels]   with one split a (row, kv head): {ms:.5f} ms")
    return ms


def _paged_moe_row(g, randn, lens):
    """K7 and K6 at mixtral-8x7b's 8-slot paged drain: (8, 9) chain blocks
    and the T = 1 step, 32/8 heads of 128, bf16, over a one-layer pool of
    blocks of 128 with the prefix's 6 blocks shared, the batch rows' first
    8 lengths. Returns K7's and K6's timing rows and their (max abs error,
    share of tolerance) pairs."""
    import torch
    import torch.nn.functional as F

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import (
        paged_attention_reference,
        paged_block_attention_reference,
    )
    from tpu_voice_agent_torch.ops.paged_attention import gather_pages

    dev = torch.device("cuda")
    B, nq, nkv, hd, bs = 8, 32, 8, 128, 128
    lens8 = lens[:B]
    tables, N = _paged_tables(g, B, 6, lens8, bs, 16)
    kp, vp = randn(1, N, bs, nkv, hd), randn(1, N, bs, nkv, hd)
    kv_len = lens8.to(torch.int32).to(dev)
    chain = torch.randint(0, 9, (B,), generator=torch.Generator().manual_seed(8)).to(dev)
    iw = torch.arange(9, device=dev)[None, :]
    qpos = (kv_len[:, None] - 10 + torch.minimum(iw, chain[:, None])).to(torch.int32)
    q = randn(B, 9, nq, hd)
    out = ops.paged_block_attention(q, kp, vp, tables, qpos, 0)
    ref = paged_block_attention_reference(q, kp, vp, tables, qpos, 0)
    S = tables.shape[1] * bs
    kh = gather_pages(kp, tables, 0).transpose(1, 2).repeat_interleave(nq // nkv, 1)
    vh = gather_pages(vp, tables, 0).transpose(1, 2).repeat_interleave(nq // nkv, 1)
    mask = (torch.arange(S, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
    keys = qpos.amax(dim=1) + 1
    shared = 6 * bs
    row = _extra_shape(
        "mixtral-8x7b's 8-slot drain: (8, 9) blocks, 32/8 heads of 128, one pool layer",
        cuda_ms(lambda: ops.paged_block_attention(q, kp, vp, tables, qpos, 0), iters=100),
        cuda_ms(lambda: paged_block_attention_reference(q, kp, vp, tables, qpos, 0)),
        *bound(2 * 2 * B * 9 * nq * hd + 4 * qpos.numel() + 4 * tables.numel()
               + (shared + float((keys - shared).sum())) * 2 * nkv * hd * 2,
               4 * nq * hd * float((qpos + 1).sum())),
        cuda_ms(lambda: F.scaled_dot_product_attention(q.transpose(1, 2), kh, vh,
                                                       attn_mask=mask), iters=100))
    q1 = q[:, 0].contiguous()
    out6 = ops.paged_attention(q1, kp, vp, tables, kv_len, 0)
    ref6 = paged_attention_reference(q1, kp, vp, tables, kv_len, 0)
    fail_if(not torch.equal(out6, ops.paged_attention(q1, kp, vp, tables, kv_len, 0)),
            "paged_attention (mixtral-8x7b): two calls on the same inputs differ")
    mask6 = (torch.arange(S, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    row6 = _extra_shape(
        "mixtral-8x7b's 8-slot drain: the T = 1 step, 32/8 heads of 128, one pool layer",
        cuda_ms(lambda: ops.paged_attention(q1, kp, vp, tables, kv_len, 0), iters=100),
        cuda_ms(lambda: paged_attention_reference(q1, kp, vp, tables, kv_len, 0)),
        *bound(2 * 2 * B * nq * hd + 4 * B + 4 * tables.numel()
               + (shared + float((kv_len - shared).sum())) * 2 * nkv * hd * 2,
               4 * nq * hd * float(kv_len.sum())),
        cuda_ms(lambda: F.scaled_dot_product_attention(q1[:, :, None], kh, vh,
                                                       attn_mask=mask6), iters=100))
    return row, row6, attn_err([(out, ref)]), attn_err([(out6, ref6)])


def _quant_moe_rows(g, randn, rows: dict) -> None:
    """K8, K9 and K10 at head dim 128: mixtral-8x7b's widths (32/8 heads of
    128) under KV_QUANT int8 and int4. K9 at the 8-slot drain's (8, 9)
    chain blocks and K8 at its T = 1 step, over a one-layer pool of blocks
    of 128 with the prefix's 6 blocks shared (kv_len 900-1050); K10 at a
    dense (1, 2048, 8, 128) cache at kv_len 944. bf16 queries (the main
    path's) are timed; fp32 queries (the fp32 body) are held too. The
    library yardstick is SDPA on a pre-gathered, pre-dequantized bf16 copy.
    Each pair's error folds into its kernel's row; each is also held to two
    calls giving the same bits."""
    import torch
    import torch.nn.functional as F

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import (
        decode_attention_quant_reference,
        paged_attention_quant_reference,
        paged_block_attention_quant_reference,
    )
    from tpu_voice_agent_torch.ops.kvquant import KV_QUANT_VBYTES, KV_SCALE_BYTES, dequantize_kv
    from tpu_voice_agent_torch.ops.paged_attention import gather_pages_dequant

    dev = torch.device("cuda")
    B, nq, nkv, hd, bs, n10 = 8, 32, 8, 128, 128, 944
    group = nq // nkv
    lens = torch.randint(900, 1051, (B,), generator=torch.Generator().manual_seed(3))
    tables, N = _paged_tables(g, B, 6, lens, bs, 16)
    kv_len = lens.to(torch.int32).to(dev)
    chain = torch.randint(0, 9, (B,), generator=torch.Generator().manual_seed(8)).to(dev)
    iw = torch.arange(9, device=dev)[None, :]
    qpos = (kv_len[:, None] - 10 + torch.minimum(iw, chain[:, None])).to(torch.int32)
    q = randn(B, 9, nq, hd)
    q1 = q[:, 0].contiguous()
    q10, kv10 = randn(1, nq, hd), torch.tensor([n10], dtype=torch.int32, device=dev)
    S = tables.shape[1] * bs
    s_idx = torch.arange(S, device=dev)
    mask9 = (s_idx[None, None, :] <= qpos[:, :, None])[:, None]
    mask8 = (s_idx[None, :] < kv_len[:, None])[:, None, None, :]
    shared, keys9 = 6 * bs, qpos.amax(dim=1) + 1
    io9 = 2 * 2 * B * 9 * nq * hd + 4 * qpos.numel() + 4 * tables.numel()
    io8 = 2 * 2 * B * nq * hd + 4 * B + 4 * tables.numel()
    names = {"8": "paged_attention_quant", "9": "paged_block_attention_quant",
             "10": "decode_attention_quant"}
    for tier, bits in (("int8", 8), ("int4", 4)):
        kp, ks = _quant_values(g, (1, N, bs, nkv, hd), tier)
        vp, vs = _quant_values(g, (1, N, bs, nkv, hd), tier)
        kc, kcs = _quant_values(g, (1, 2048, nkv, hd), tier)
        vc, vcs = _quant_values(g, (1, 2048, nkv, hd), tier)
        k9 = lambda x: ops.paged_block_attention_quant(x, kp, vp, ks, vs, tables, qpos, 0,
                                                       bits=bits)
        p9 = lambda x: paged_block_attention_quant_reference(x, kp, vp, ks, vs, tables, qpos, 0,
                                                             bits=bits)
        k8 = lambda x: ops.paged_attention_quant(x, kp, vp, ks, vs, tables, kv_len, 0, bits=bits)
        p8 = lambda x: paged_attention_quant_reference(x, kp, vp, ks, vs, tables, kv_len, 0,
                                                       bits=bits)
        k10 = lambda x: ops.decode_attention_quant(x, kc, vc, kcs, vcs, kv10, bits=bits)
        p10 = lambda x: decode_attention_quant_reference(x, kc, vc, kcs, vcs, kv10, bits=bits)
        pairs = {"9": [(k9(x), p9(x)) for x in (q, q.float())],
                 "8": [(k8(x), p8(x)) for x in (q1, q1.float())],
                 "10": [(k10(x), p10(x)) for x in (q10, q10.float())]}
        for key, fn, x in (("9", k9, q), ("8", k8, q1), ("10", k10, q10)):
            fail_if(not torch.equal(fn(x), fn(x)),
                    f"{names[key]} (hd 128, {tier}): two calls on the same inputs differ")
        kh = gather_pages_dequant(kp, ks, tables, 0, bits).to(torch.bfloat16)
        vh = gather_pages_dequant(vp, vs, tables, 0, bits).to(torch.bfloat16)
        kh = kh.transpose(1, 2).repeat_interleave(group, 1)
        vh = vh.transpose(1, 2).repeat_interleave(group, 1)
        kd = dequantize_kv(kc[:, :n10], kcs[:, :n10], tier).transpose(1, 2)
        vd = dequantize_kv(vc[:, :n10], vcs[:, :n10], tier).transpose(1, 2)
        kd, vd = kd.repeat_interleave(group, 1), vd.repeat_interleave(group, 1)
        kv_row = 2 * nkv * (hd * KV_QUANT_VBYTES[tier] + KV_SCALE_BYTES[tier])
        timed = {
            "9": ("(8, 9) chain blocks", cuda_ms(lambda: k9(q), iters=100),
                  cuda_ms(lambda: p9(q), iters=5),
                  *bound(io9 + (shared + float((keys9 - shared).sum())) * kv_row,
                         4 * nq * hd * float((qpos + 1).sum())),
                  cuda_ms(lambda: F.scaled_dot_product_attention(
                      q.transpose(1, 2), kh, vh, attn_mask=mask9), iters=100)),
            "8": ("the T = 1 step", cuda_ms(lambda: k8(q1), iters=100),
                  cuda_ms(lambda: p8(q1), iters=5),
                  *bound(io8 + (shared + float((kv_len - shared).sum())) * kv_row,
                         4 * nq * hd * float(kv_len.sum())),
                  cuda_ms(lambda: F.scaled_dot_product_attention(
                      q1[:, :, None], kh, vh, attn_mask=mask8), iters=100)),
            "10": (f"a dense (1, 2048, 8, 128) cache at kv_len {n10}",
                   cuda_ms(lambda: k10(q10), iters=100), cuda_ms(lambda: p10(q10), iters=5),
                   *bound(2 * 2 * nq * hd + 4 + n10 * kv_row, 4 * nq * hd * n10),
                   cuda_ms(lambda: F.scaled_dot_product_attention(q10[:, :, None], kd, vd),
                           iters=100)),
        }
        for key, name in names.items():
            err, ratio = attn_err(pairs[key])
            log(f"[kernels]   {name} hd 128 {tier} pairs (bf16, fp32 q): " + ", ".join(
                f"{e:.3g} ({r:.3g})" for e, r in (attn_err([pr]) for pr in pairs[key])))
            fail_if(not ratio <= 1.0, f"{name} (hd 128, {tier}): error {ratio:.3g}x its "
                    f"tolerance (max abs err {err})")
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["err_over_tol"] = max(row["err_over_tol"], ratio)
            label, *t = timed[key]
            row[f"mixtral_{tier}"] = _extra_shape(
                f"mixtral-8x7b, 32/8 heads of 128, {tier}: {label}"
                + ("" if key == "10" else ", one pool layer of blocks of 128"), *t)
        del kp, vp, ks, vs, kc, vc, kcs, vcs, kh, vh, kd, vd
    for name in names.values():
        rows[name]["tol"] = f"{ATTN_TOL} (bf16); {F32_TOL} (fp32, hd 48 and 128)"


# K13 at mixtral-8x7b's widths (8 experts, top-2, dim 4096, ffn 14336): the
# rows of one T = 1 decode step, of an ff=8 (1, 9) block and of the 1024-token
# prefix prefill bucket, laid out by the path's own grouped_layout
GMM_SHAPES = (("decode", 1), ("ff=8 block", 9), ("prefix prefill", 1024))


def _gmm_operands(g, Tt: int, d: int, f: int, E: int, dtype):
    """The grouped dispatch's rows for Tt tokens routed top-2 by a random
    router: x (M_pad, d) with each expert's run zero-padded and random rows
    in the tail past the live rows (the kernel must write zeros there
    without reading them), the per-tile expert ids, tm, the live row count,
    and the distinct experts named by every tile and by the live ones."""
    import torch

    from tpu_voice_agent_torch.models.llama import grouped_layout
    from tpu_voice_agent_torch.models.moe import route_topk_flat

    dev = torch.device("cuda")
    h = torch.randn(Tt, d, generator=g, device=dev)
    router = torch.randn(d, E, generator=g, device=dev) * d ** -0.5
    eids, _ = route_topk_flat(router, h, E, 2)
    order, pos, tm, M_pad, te, live = grouped_layout(eids.reshape(-1).long(), E)
    x = torch.zeros(M_pad, d, dtype=dtype, device=dev)
    n_live = int(live)
    x[n_live:] = torch.randn(M_pad - n_live, d, generator=g, device=dev).to(dtype)
    x[pos] = h[order // 2].to(dtype)
    tiles = te.tolist()
    return x, te, tm, live, len(set(tiles)), len(set(tiles[:n_live // tm]))


def _gmm_kernel_rows(g) -> dict:
    """K13 against its plain version at the MoE path's shapes (GMM_SHAPES),
    both orientations (gate/up: x (M, 4096) by (8, 4096, 14336); down: x
    (M, 14336) by (8, 14336, 4096)), bf16, each with a dense bf16 w and with
    the int8 leaf, which must equal the dense form on its dequantized values
    bit for bit; and fp32 at mixtral-test's widths (4 experts, 128 x 256).
    Every call passes the layout's ``live_rows``: the tail tiles must come
    out as zeros (their x rows are random), and two calls must give the same
    bits. Bounds count what these inputs need: x's live rows read and the
    output's M_pad rows written, each distinct expert plane the live tiles
    name read once, 2 live d f operations; ``bound_all_tiles`` keeps the
    count over every tile (x at M_pad rows, every tile's plane). Library:
    ``torch._grouped_mm`` on the dense bf16 operands (groups from the padded
    runs, the tail in expert E-1), where the installed PyTorch has it and
    takes them; ``library_live_ms`` the same call on the live rows alone."""
    import torch

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.models.llama import quantize_leaf
    from tpu_voice_agent_torch.ops import dequantize_leaf, grouped_matmul_reference

    dev = torch.device("cuda")
    E, dm, fm = 8, 4096, 14336
    worst = [0.0, 0.0]
    lib_note = []

    def check(x, w, te, tm, live):
        dense = dequantize_leaf(w)
        out = ops.grouped_matmul(x, w, te, tm, live_rows=live)
        fail_if(not torch.equal(out, ops.grouped_matmul(x, w, te, tm, live_rows=live)),
                "grouped_matmul: two calls on the same inputs differ")
        fail_if(not bool((out[int(live):] == 0).all()),
                "grouped_matmul: the tail tiles past live_rows are not zeros")
        ref = grouped_matmul_reference(x, dense, te, tm, live_rows=live)
        mag = grouped_matmul_reference(x.abs().float(), dense.abs(), te, tm, live_rows=live)
        rtol = ATTN_RTOL if x.dtype == torch.bfloat16 else F32_RTOL
        atol = ATTN_ATOL if x.dtype == torch.bfloat16 else 0.0
        err = (out.float() - ref.float()).abs()
        worst[0] = max(worst[0], float(err.max()))
        worst[1] = max(worst[1], float((err / (rtol * ref.float().abs() + atol
                                               + GMM_SUM_TOL * mag)).max()))
        if isinstance(w, dict):
            fail_if(not torch.equal(out, ops.grouped_matmul(x, dense, te, tm, live_rows=live)),
                    "grouped_matmul: the int8 leaf differs from the dense form on its "
                    "dequantized values")

    def library(x, w, te, tm):
        if not hasattr(torch, "_grouped_mm"):
            lib_note.append(f"torch {torch.__version__} has no torch._grouped_mm")
            return None
        counts = torch.bincount(te.long(), minlength=E) * tm
        offs = torch.cumsum(counts, 0).to(torch.int32)
        try:
            torch._grouped_mm(x, w, offs=offs)
        except (RuntimeError, TypeError) as e:  # a yardstick only: the port never calls it
            lib_note.append(f"torch._grouped_mm refused the operands: {str(e)[:160]}")
            return None
        return cuda_ms(lambda: torch._grouped_mm(x, w, offs=offs))

    timings = {}
    for orient, (d, f) in (("gate/up", (dm, fm)), ("down", (fm, dm))):
        w = (torch.randn(E, d, f, generator=g, device=dev) * d ** -0.5).to(torch.bfloat16)
        leaf = quantize_leaf(w)
        for label, Tt in GMM_SHAPES:
            x, te, tm, live, planes, live_planes = _gmm_operands(g, Tt, d, f, E, torch.bfloat16)
            M, n_live = x.shape[0], int(live)
            check(x, w, te, tm, live)
            check(x, leaf, te, tm, live)
            io = 2 * n_live * d + 2 * M * f + 4 * te.numel() + 4
            io_all = 2 * M * d + 2 * M * f + 4 * te.numel()
            ops_n, ops_all = 2 * n_live * d * f, 2 * M * d * f
            key = f"{label} {orient}"
            timings[key] = {
                "int8": (cuda_ms(lambda: ops.grouped_matmul(x, leaf, te, tm, live_rows=live)),
                         *bound(io + live_planes * (d * f + 4 * f), ops_n),
                         bound(io_all + planes * (d * f + 4 * f), ops_all)[0]),
                "bf16": (cuda_ms(lambda: ops.grouped_matmul(x, w, te, tm, live_rows=live)),
                         *bound(io + live_planes * 2 * d * f, ops_n),
                         bound(io_all + planes * 2 * d * f, ops_all)[0]),
                "plain_ms": cuda_ms(lambda: grouped_matmul_reference(x, w, te, tm,
                                                                     live_rows=live),
                                    iters=3, warmup=1),
                "library_ms": library(x, w, te, tm),
                "library_live_ms": library(x[:n_live], w, te[:n_live // tm], tm),
                "shape": (f"{label}: {Tt} token(s), top-2 of 8, tm {tm}, x ({M}, {d}) bf16 "
                          f"({M // tm} tiles, {n_live // tm} live, {live_planes} distinct "
                          f"experts live), w (8, {d}, {f})")}
            del x
        del w, leaf
    torch.cuda.empty_cache()
    # fp32 activations at mixtral-test's widths (the identity check's engine):
    # an fp32 w and the int8 leaf, both orientations, an ff=8 block's rows
    for d, f in ((128, 256), (256, 128)):
        w32 = torch.randn(4, d, f, generator=g, device=dev) * d ** -0.5
        x, te, tm, live, _, _ = _gmm_operands(g, 9, d, f, 4, torch.float32)
        check(x, w32, te, tm, live)
        check(x, quantize_leaf(w32.bfloat16()), te, tm, live)
    torch.cuda.synchronize()
    main = timings["decode gate/up"]
    row = _kernel_row("grouped_matmul", worst[0], worst[1], GMM_TOL, main["int8"][0],
                      main["plain_ms"], main["int8"][1], main["int8"][2], main["library_ms"])
    row["bound_all_tiles"] = main["int8"][3]
    row["deterministic"] = True
    row["shape"] = main["shape"] + ", the int8 leaf (the main path's); library and plain on " \
        "the dense bf16 w"
    for key, t in timings.items():
        for form in ("int8", "bf16"):
            extra = _extra_shape(
                f"{t['shape']}, {'int8 leaf' if form == 'int8' else 'dense bf16 w'}",
                t[form][0], t["plain_ms"], t[form][1], t[form][2], t["library_ms"])
            extra["bound_all_tiles"] = t[form][3]
            extra["library_live_ms"] = t["library_live_ms"]
            row[f"{key}, {form}"] = extra
    if lib_note:
        row["library_note"] = sorted(set(lib_note))
        log(f"[kernels]   grouped_matmul library: {row['library_note']}")
    return {"grouped_matmul": row}


def _quant_values(g, shape, tier: str):
    """Stored values and bf16 scales as the engine writes them: unit-normal
    k or v rows through ``ops.kvquant.quantize_kv``, one leading slice
    (a layer of a pool) at a time."""
    import torch

    from tpu_voice_agent_torch.ops.kvquant import kv_store_dim, quantize_kv

    vals = torch.empty((*shape[:-1], kv_store_dim(shape[-1], tier)), dtype=torch.int8,
                       device=g.device)
    scales = torch.empty(shape[:-1], dtype=torch.bfloat16, device=g.device)
    for i in range(shape[0]):
        vals[i], scales[i] = quantize_kv(
            torch.randn(shape[1:], generator=g, device=g.device), tier)
    return vals, scales


def _quant_kernel_rows(g, randn, n: int) -> dict:
    """K8 and K9 at the kvquant phase's shapes: the batch rows of K6 / K7
    (32 rows, 22 layers, blocks of 128, 4 kv heads of 64, the prefix's 6
    blocks shared, kv_len 905-1044, a (32, 9) block) over a pool of the bf16
    cell's byte budget, 994 blocks at int8 and 1,931 at int4; the int8
    timings make the row and the int4 ones sit beside it. K10 at K2's shape:
    a dense (1, 2048, 4, 64) cache at kv_len ``n``. Each is also held at the
    distilled checkpoint's head dim 48 at int4, whose 24-byte rows start
    off a 16-byte boundary (4 heads, 2 kv heads, blocks of 16 and 128). The
    library yardstick is SDPA on a pre-gathered, pre-dequantized bf16 copy
    (neither timed), as the K6 / K7 rows have it. K9 also at the (32, 5) spec
    verify block; K8 and K9 with one split a (row, kv head)
    (``one_split_ms``), K8 also with rows at kv_len 0, 1 and off the 64-key
    tiles, and at block sizes 16, 32
    and 64 (bf16 queries, 2-layer pools); both two calls bit-equal."""
    import torch
    import torch.nn.functional as F

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.ops import (
        decode_attention_quant_reference,
        paged_attention_quant_reference,
        paged_block_attention_quant_reference,
    )
    from tpu_voice_agent_torch.ops.kvquant import (
        KV_QUANT_VBYTES,
        KV_SCALE_BYTES,
        dequantize_kv,
        kv_block_bytes,
    )
    from tpu_voice_agent_torch.ops.paged_attention import gather_pages_dequant

    dev = torch.device("cuda")
    L, bs, nq, nkv, hd, B = 22, 128, 32, 4, 64, 32
    group, li = nq // nkv, L - 1
    budget = 513 * kv_block_bytes(L, bs, nkv, hd, None)
    lens = torch.randint(900, 1051, (B,), generator=torch.Generator().manual_seed(3))
    tables, _ = _paged_tables(g, B, 6, lens, bs, 16)
    kv_len = lens.to(torch.int32).to(dev)
    chain = torch.randint(0, 9, (B,), generator=torch.Generator().manual_seed(4)).to(dev)
    iw = torch.arange(9, device=dev)[None, :]
    qpos = (kv_len[:, None] - 10 + torch.minimum(iw, chain[:, None])).to(torch.int32)
    q, q9 = randn(B, nq, hd), randn(B, 9, nq, hd)
    # the spec verify step: [cur, 4 drafts]
    q5, qpos5 = q9[:, :5].contiguous(), (kv_len[:, None] - 5 + iw[:, :5]).to(torch.int32)
    S = tables.shape[1] * bs
    s_idx = torch.arange(S, device=dev)
    mask8 = (s_idx[None, :] < kv_len[:, None])[:, None, None, :]
    mask9 = (s_idx[None, None, :] <= qpos[:, :, None])[:, None]
    mask5 = (s_idx[None, None, :] <= qpos5[:, :, None])[:, None]
    shared = 6 * bs
    keys9 = qpos.amax(dim=1) + 1
    keys5 = qpos5.amax(dim=1) + 1
    io5 = 2 * 2 * B * 5 * nq * hd + 4 * qpos5.numel() + 4 * tables.numel()
    io8 = 2 * 2 * B * nq * hd + 4 * B + 4 * tables.numel()
    io9 = 2 * 2 * B * 9 * nq * hd + 4 * qpos.numel() + 4 * tables.numel()

    # K10 at K2's shape, and the hd-48 int4 checks on small pools
    kv10 = torch.tensor([n], dtype=torch.int32, device=dev)
    q1 = randn(1, nq, hd)
    g48 = torch.Generator(device=dev).manual_seed(48)
    q48, q48_9 = randn(15, 4, 48, dtype=torch.float32), randn(15, 9, 4, 48, dtype=torch.float32)
    lens48 = torch.randint(60, 300, (15,), generator=torch.Generator().manual_seed(48))

    timings, errs = {}, {"8": [], "9": [], "10": []}
    for tier, bits in (("int8", 8), ("int4", 4)):
        N = budget // kv_block_bytes(L, bs, nkv, hd, tier)
        kp, ks = _quant_values(g, (L, N, bs, nkv, hd), tier)
        vp, vs = _quant_values(g, (L, N, bs, nkv, hd), tier)
        k8 = lambda: ops.paged_attention_quant(q, kp, vp, ks, vs, tables, kv_len, li, bits=bits)
        k9 = lambda: ops.paged_block_attention_quant(q9, kp, vp, ks, vs, tables, qpos, li,
                                                     bits=bits)
        p8 = lambda: paged_attention_quant_reference(q, kp, vp, ks, vs, tables, kv_len, li,
                                                     bits=bits)
        p9 = lambda: paged_block_attention_quant_reference(q9, kp, vp, ks, vs, tables, qpos, li,
                                                           bits=bits)
        ref8 = p8()
        errs["8"].append((k8(), ref8))
        fail_if(not torch.equal(k8(), k8()),
                f"paged_attention_quant ({tier}): two calls on the same inputs differ")
        # rows at kv_len 0 (zeros), 1, and lengths off the 64-key tiles
        kz = kv_len.clone()
        kz[:4] = torch.tensor([0, 1, 77, 129], dtype=torch.int32)
        o8z = ops.paged_attention_quant(q, kp, vp, ks, vs, tables, kz, li, bits=bits)
        fail_if(not bool((o8z[0] == 0).all()),
                f"paged_attention_quant ({tier}): a kv_len-0 row is not zeros")
        errs["8"].append((o8z, paged_attention_quant_reference(q, kp, vp, ks, vs, tables, kz, li,
                                                               bits=bits)))
        ref9 = p9()
        errs["9"].append((k9(), ref9))
        # bf16 queries run the split body: the same bits from run to run
        fail_if(not torch.equal(k9(), k9()),
                f"paged_block_attention_quant ({tier}): two calls on the same inputs differ")
        k9s = lambda: ops.paged_block_attention_quant(q5, kp, vp, ks, vs, tables, qpos5, li,
                                                      bits=bits)
        p9s = lambda: paged_block_attention_quant_reference(q5, kp, vp, ks, vs, tables, qpos5,
                                                            li, bits=bits)
        errs["9"].append((k9s(), p9s()))
        kh = gather_pages_dequant(kp, ks, tables, li, bits).to(torch.bfloat16)
        vh = gather_pages_dequant(vp, vs, tables, li, bits).to(torch.bfloat16)
        kh = kh.transpose(1, 2).repeat_interleave(group, 1)
        vh = vh.transpose(1, 2).repeat_interleave(group, 1)
        kv_row = 2 * nkv * (hd * KV_QUANT_VBYTES[tier] + KV_SCALE_BYTES[tier])
        t = {"pool_blocks": N, "kv_bytes_per_position": kv_row,
             "8": (cuda_ms(k8, iters=100), cuda_ms(p8, iters=5),
                   *bound(io8 + (shared + float((kv_len - shared).sum())) * kv_row,
                          4 * nq * hd * float(kv_len.sum())),
                   cuda_ms(lambda: F.scaled_dot_product_attention(
                       q[:, :, None], kh, vh, attn_mask=mask8), iters=100)),
             "9": (cuda_ms(k9, iters=100), cuda_ms(p9, iters=5),
                   *bound(io9 + (shared + float((keys9 - shared).sum())) * kv_row,
                          4 * nq * hd * float((qpos + 1).sum())),
                   cuda_ms(lambda: F.scaled_dot_product_attention(
                       q9.transpose(1, 2), kh, vh, attn_mask=mask9), iters=100)),
             "9s": (cuda_ms(k9s, iters=100), cuda_ms(p9s, iters=5),
                    *bound(io5 + (shared + float((keys5 - shared).sum())) * kv_row,
                           4 * nq * hd * float((qpos5 + 1).sum())),
                    cuda_ms(lambda: F.scaled_dot_product_attention(
                        q5.transpose(1, 2), kh, vh, attn_mask=mask5), iters=100)),
             "one_split": _one_split_ms(k9, ref9),
             "one_split8": _one_split_ms(k8, ref8, "paged_t1_chunk")}
        del kp, vp, ks, vs, kh, vh
        for sbs in (16, 32, 64):  # K8 with bf16 queries at the other block sizes
            t_s, n_s = _paged_tables(g, B, 768 // sbs, kv_len.tolist(), sbs, -(-1100 // sbs))
            kps, kss = _quant_values(g, (2, n_s, sbs, nkv, hd), tier)
            vps, vss = _quant_values(g, (2, n_s, sbs, nkv, hd), tier)
            errs["8"].append((
                ops.paged_attention_quant(q, kps, vps, kss, vss, t_s, kv_len, 1, bits=bits),
                paged_attention_quant_reference(q, kps, vps, kss, vss, t_s, kv_len, 1,
                                                bits=bits)))
            del kps, vps, kss, vss
        # K10: a dense (1, 2048, 4, 64) cache
        kc, kcs = _quant_values(g, (1, 2048, nkv, hd), tier)
        vc, vcs = _quant_values(g, (1, 2048, nkv, hd), tier)
        k10 = lambda: ops.decode_attention_quant(q1, kc, vc, kcs, vcs, kv10, bits=bits)
        p10 = lambda: decode_attention_quant_reference(q1, kc, vc, kcs, vcs, kv10, bits=bits)
        errs["10"].append((k10(), p10()))
        # split across blocks and merged in a fixed order: the same bits run to run
        fail_if(not torch.equal(k10(), k10()),
                f"decode_attention_quant ({tier}): two calls on the same inputs differ")
        kd = dequantize_kv(kc[:, :n], kcs[:, :n], tier).transpose(1, 2).repeat_interleave(group, 1)
        vd = dequantize_kv(vc[:, :n], vcs[:, :n], tier).transpose(1, 2).repeat_interleave(group, 1)
        t["10"] = (cuda_ms(k10, iters=100), cuda_ms(p10, iters=5),
                   *bound(2 * 2 * nq * hd + 4 + n * kv_row, 4 * nq * hd * n),
                   cuda_ms(lambda: F.scaled_dot_product_attention(q1[:, :, None], kd, vd),
                           iters=100))
        timings[tier] = t
        # the distilled checkpoint's widths (hd 48, fp32 queries) at this tier
        for sbs in (16, 128):
            t48, n48 = _paged_tables(g48, 15, 0, lens48, sbs, -(-300 // sbs))
            kp48, ks48 = _quant_values(g48, (3, n48, sbs, 2, 48), tier)
            vp48, vs48 = _quant_values(g48, (3, n48, sbs, 2, 48), tier)
            kl48 = lens48.to(torch.int32).to(dev)
            qp48 = (kl48[:, None] - 9 + iw).to(torch.int32)
            errs["8"].append((
                ops.paged_attention_quant(q48, kp48, vp48, ks48, vs48, t48, kl48, 2, bits=bits),
                paged_attention_quant_reference(q48, kp48, vp48, ks48, vs48, t48, kl48, 2,
                                                bits=bits)))
            errs["9"].append((
                ops.paged_block_attention_quant(q48_9, kp48, vp48, ks48, vs48, t48, qp48, 1,
                                                bits=bits),
                paged_block_attention_quant_reference(q48_9, kp48, vp48, ks48, vs48, t48, qp48,
                                                      1, bits=bits)))
        kc48, kcs48 = _quant_values(g48, (15, 300, 2, 48), tier)
        vc48, vcs48 = _quant_values(g48, (15, 300, 2, 48), tier)
        # the distilled widths (a group of 2, splits of 64 keys: the
        # warps-on-keys body), also with row 0 at kv_len 0 (zeros)
        kz48 = kl48.clone()
        kz48[0] = 0
        for lens in (kl48, kz48):
            o10, again = (ops.decode_attention_quant(q48, kc48, vc48, kcs48, vcs48, lens,
                                                     bits=bits) for _ in range(2))
            fail_if(not bool((o10[lens == 0] == 0).all()) or not torch.equal(o10, again),
                    f"decode_attention_quant ({tier}, hd 48): a kv_len-0 row is not zeros, or "
                    "two calls differ")
            errs["10"].append((o10, decode_attention_quant_reference(
                q48, kc48, vc48, kcs48, vcs48, lens, bits=bits)))
    torch.cuda.synchronize()
    for key, pairs in errs.items():  # each pair's (max abs error, share of its tolerance)
        log(f"[kernels]   K{key} pairs: " + ", ".join(
            f"{e:.3g} ({r:.3g})" for e, r in (attn_err([pr]) for pr in pairs)))

    rows = {}
    shapes = {
        "8": "B 32 at kv_len {lo}-{hi} over a (22, N, 128, 4, hdp) pool, 6 shared prefix "
             "blocks, N = {N} (the bf16 cell's bytes)",
        "9": "(32, 9) blocks, chains of 0-8 padded with duplicates, over the same pool",
        "10": "a dense (1, 2048, 4, hdp) cache at kv_len {n}",
    }
    for key, name in (("8", "paged_attention_quant"), ("9", "paged_block_attention_quant"),
                      ("10", "decode_attention_quant")):
        i8, i4 = timings["int8"], timings["int4"]
        rows[name] = _kernel_row(name, *attn_err(errs[key]),
                                 f"{ATTN_TOL} (bf16); {F32_TOL} (fp32, hd 48)", *i8[key])
        fmt = dict(lo=int(kv_len.min()), hi=int(kv_len.max()), n=n)
        rows[name]["shape"] = (shapes[key].format(N=i8["pool_blocks"], **fmt)
                               + ", int8; hd 48 int4 and int8 checked on small pools")
        rows[name]["int4"] = _extra_shape(
            shapes[key].format(N=i4["pool_blocks"], **fmt) + ", int4", *i4[key])
    k9 = rows["paged_block_attention_quant"]
    k9["deterministic"] = rows["paged_attention_quant"]["deterministic"] = True
    for tier in ("int8", "int4"):
        k9[f"spec_{tier}"] = _extra_shape(
            f"the (32, 5) spec verify block over the same pool, {tier}", *timings[tier]["9s"])
        k9[f"one_split_ms_{tier}"] = timings[tier]["one_split"]
        rows["paged_attention_quant"][f"one_split_ms_{tier}"] = timings[tier]["one_split8"]
    return rows


class Counted:
    """Launch counters over one driven path: set to 0 on entry, read on
    exit, summed into the report's per-kernel ``launches``."""

    def __init__(self, name: str, totals: dict):
        self.name, self.totals, self.counts = name, totals, {}

    def __enter__(self):
        from tpu_voice_agent_torch import ops

        ops.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        import torch

        from tpu_voice_agent_torch import ops

        torch.cuda.synchronize()
        self.counts = ops.launch_counts()
        for k, v in self.counts.items():
            self.totals[k] = self.totals.get(k, 0) + v
        log(f"[{self.name}] launches {json.dumps(self.counts)}")
        return False

    def require(self, *names: str) -> None:
        for n in names:
            fail_if(self.counts.get(n, 0) <= 0, f"{self.name}: {n} never launched")


def _post(base: str, body: dict, headers: dict | None = None,
          send: dict | None = None) -> tuple[int, dict]:
    """POST /parse with the request headers ``send``; the response headers
    go into ``headers`` when given."""
    req = urllib.request.Request(base + "/parse", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json", **(send or {})},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            if headers is not None:
                headers.update(r.headers)
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        if headers is not None:
            headers.update(e.headers)
        return e.code, json.loads(e.read())


def _serve(server):
    """Run an http.server on a daemon thread: (server, thread, base URL)."""
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _serve_brain(app):
    """The port's brain service for ``app`` on an ephemeral port."""
    from tpu_voice_agent_torch.services import brain

    return _serve(brain.make_server(app, port=0))


def _stop(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)


def phase_service(totals: dict, report: dict):
    """Boot the port's brain service on an ephemeral port and POST /parse."""
    from tpu_voice_agent_torch.schemas import validate_parse_response
    from tpu_voice_agent_torch.services import brain

    os.environ.update(BRAIN_BACKEND="engine:tinyllama-1.1b", BRAIN_QUANT="int8")
    for k in ("BRAIN_FF", "BRAIN_PREFIX", "BRAIN_DEVICE", "BRAIN_BATCH"):
        os.environ.pop(k, None)
    with Counted("service", totals) as c:
        t0 = time.perf_counter()
        parser = brain.make_parser_from_env()
        eng = parser.engine
        log(f"[service] boot {time.perf_counter() - t0:.2f} s: {eng.cfg.n_layers} layers, "
            f"dim {eng.cfg.dim}, quant {eng.quant}, ff {eng.fast_forward}, "
            f"kernels {eng.kernels}, device {eng.device}, prefix {len(eng.prefix_ids)} tokens")
        fail_if(eng.device.type != "cuda" or eng.kernels != "kernels", "engine not on the card")
        fail_if(eng.fast_forward != 8 or eng.quant != "int8" or not eng.prefix_ids,
                "service not at ff 8 / int8 / cached prefix")
        server, thread, base = _serve_brain(brain.BrainApp(parser))
        rows = []
        try:
            with urllib.request.urlopen(base + "/health", timeout=60) as r:
                log(f"[service] /health {json.loads(r.read())}")
            for text in UTTERANCES[:3]:
                t1 = time.perf_counter()
                status, body = _post(base, {"text": text, "context": {}})
                wall = (time.perf_counter() - t1) * 1e3
                res = parser.last_result
                fail_if(res is None, f"no engine result for {text!r}: {status} {body}")
                fail_if(res.error is not None, f"poisoned row on {text!r}: {res.error}")
                # random weights run out of budget before EOS (422); a walk
                # that does reach EOS must be a valid ParseResponse (200)
                truncated = (status == 422 and body.get("error") == "schema_validation_failed"
                             and body.get("detail", "").startswith("decode truncated after"))
                complete = (status == 200 and res.finished
                            and validate_parse_response(body) == (body, None))
                fail_if(not (truncated or complete),
                        f"/parse {text!r}: expected 422 truncation or a valid 200, got "
                        f"{status} {body}")
                row = {"text": text, "status": status, "wall_ms": wall,
                       "prompt_tokens": res.prompt_tokens, "cached_tokens": res.cached_tokens,
                       "prefill_ms": res.prefill_ms, "decode_ms": res.decode_ms,
                       "tokens": res.steps, "forwards": res.forwards,
                       "ms_per_forward": res.decode_ms / max(res.forwards, 1)}
                rows.append(row)
                log(f"[service] /parse {status} {body.get('detail', 'ok')!r}: prompt "
                    f"{res.prompt_tokens} "
                    f"(cached {res.cached_tokens}) prefill {res.prefill_ms:.2f} ms decode "
                    f"{res.decode_ms:.2f} ms tokens {res.steps} forwards {res.forwards} "
                    f"{row['ms_per_forward']:.3f} ms/forward wall {wall:.1f} ms")
        finally:
            _stop(server, thread)
    c.require("flash_attention", "decode_block_attention_layer", "masked_argmax_advance")
    report["service"] = {"prefix_tokens": len(eng.prefix_ids), "requests": rows,
                         "launches": c.counts}
    return eng


def _bench_prompt(engine, text: str) -> str:
    """bench.py's parse_text prompt: shrink the utterance until the prompt
    leaves room for 64 new tokens in the 1024-token cache."""
    from tpu_voice_agent_torch.services.prompts import render_prompt

    for clamp in (100, 50, 20, 8, 0):
        prompt = render_prompt(text[:clamp], {"last_query": None})
        if len(engine.tokenizer.encode(prompt, bos=True)) <= 1024 - 66:
            break
    return prompt


def _plain_top2(eng, prompt_ids: list[int], tokens: list[int]) -> dict:
    """The two best legal next tokens after ``prompt_ids + tokens`` under a
    plain teacher-forced forward (plain cache attention, no kernel), their
    logit margin, and the best one's logit. On a quantized pool the forward
    stores its k/v at the engine's tier and attends them dequantized
    (``forward_paged``'s plain gather path), so the margin is that tier's;
    the bf16 cache's reading rides along under ``bf16``."""
    import torch

    from tpu_voice_agent_torch.models.llama import forward, forward_paged, init_kv_cache
    from tpu_voice_agent_torch.ops.kvquant import kv_store_dim, kv_store_dtype

    seq = prompt_ids + tokens
    dev = eng.device
    toks = torch.tensor([seq], dtype=torch.int32, device=dev)
    pos = torch.arange(len(seq), dtype=torch.int32, device=dev)[None]
    legal = torch.from_numpy(eng.fsm.mask[max(eng.fsm.walk(tokens), 0)]).to(eng.device)

    def top2(logits) -> dict:
        top = torch.topk(torch.where(legal, logits[0, -1].float(), -1e30), 2)
        v, i = top.values.tolist(), top.indices.tolist()
        return {"top2": i, "margin": v[0] - v[1], "top_logit": v[0]}

    cache = init_kv_cache(eng.cfg, 1, len(seq), device=dev)
    bf16 = top2(forward(eng.params, eng.cfg, toks, pos, cache, attn_impl="torch")[0])
    tier = getattr(eng, "kv_quant", None)
    if tier is None:
        return bf16
    cfg, bs = eng.cfg, eng.block_size
    nb = -(-len(seq) // bs)
    shape = (cfg.n_layers, nb + 1, bs, cfg.n_kv_heads)
    pools = [torch.zeros((*shape, kv_store_dim(cfg.head_dim, tier)),
                         dtype=kv_store_dtype(tier), device=dev) for _ in range(2)]
    scales = [torch.zeros(shape, dtype=torch.bfloat16, device=dev) for _ in range(2)]
    table = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)[None]
    logits = forward_paged(eng.params, cfg, toks, pos, *pools, table, attn_impl="torch",
                           k_scale=scales[0], v_scale=scales[1], kv_quant=tier)
    return {**top2(logits), "bf16": bf16}


def _ulps(d: dict) -> float:
    """A top-2 margin in bf16 ulps (2^-8) of the top logit."""
    return d["margin"] / max(2.0 ** -8 * abs(d["top_logit"]), 1e-30)


def phase_parse(params, totals: dict, report: dict) -> None:
    """bench.py's parse (bench.py:188-209): DecodeEngine(tinyllama-1.1b,
    int8, max_len 1024, prefill bucket 1024) behind the cached prefix,
    generate(max_new_tokens=64), which stops at EOS or after 64 tokens;
    p50 over bench.py's 5 utterances, at ff=8 and at ff=0 on one weight set.
    Every token of a timed parse is a plan token: tokens and forwards are
    reported beside the times, since random weights may close the JSON
    before 64 tokens."""
    import torch

    from tpu_voice_agent_torch.serve.engine import DecodeEngine
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    out, ids = {}, {}
    for ff, kernel in ((8, "decode_block_attention_layer"), (0, "decode_attention_layer")):
        with Counted(f"parse ff={ff}", totals) as c:
            eng = DecodeEngine(preset="tinyllama-1.1b", quant="int8", fast_forward=ff,
                               max_len=1024, prefill_buckets=(1024,), init_weights=False)
            eng.load_params(params)
            prefix = install_prompt_prefix(eng)
            eng.generate(_bench_prompt(eng, UTTERANCES[0]), max_new_tokens=64)
            walls, results = [], []
            for text in UTTERANCES:
                prompt = _bench_prompt(eng, text)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = eng.generate(prompt, max_new_tokens=64)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                results.append(res)
                fail_if(res.error is not None, f"parse ff={ff}: {res.error}")
                fail_if(not (res.finished or res.steps == 64),
                        f"parse ff={ff}: stopped after {res.steps} tokens without EOS")
        c.require(kernel, "masked_argmax_advance")
        ids[ff] = [r.token_ids for r in results]
        toks = [r.steps for r in results]
        fwd = [r.forwards for r in results]
        dec = [r.decode_ms for r in results]
        pre = [r.prefill_ms for r in results]
        out[f"ff{ff}"] = {"prefix_tokens": prefix, "p50_ms": statistics.median(walls),
                          "walls_ms": walls, "prefill_ms": pre, "decode_ms": dec,
                          "tokens": toks, "forwards": fwd,
                          "finished": [r.finished for r in results], "launches": c.counts,
                          "ms_per_forward": [d / f for d, f in zip(dec, fwd)],
                          "ms_per_token": [w / t for w, t in zip(walls, toks)],
                          "token_ids": ids[ff]}
        log(f"[parse] ff={ff}: p50 {statistics.median(walls):.2f} ms over {len(walls)} "
            f"(walls {[round(w, 2) for w in walls]}), prefill p50 "
            f"{statistics.median(pre):.2f} ms, decode p50 {statistics.median(dec):.2f} ms, "
            f"tokens {toks}, forwards {fwd}, ms/forward p50 "
            f"{statistics.median(out[f'ff{ff}']['ms_per_forward']):.3f}, ms/token p50 "
            f"{statistics.median(out[f'ff{ff}']['ms_per_token']):.3f}")
    # fast-forward emits a forced byte run in the grammar's canonical
    # tokenization, where T=1 greedy decoding may pick another tokenization
    # of the same bytes (',' where the chain has ',"context_updates":'); from
    # there the two parses see different tokens and go separate ways. So a
    # difference is reported, not failed: the step where they part, whether
    # ff=8's token there heads a forced chain, and the plain forward's top-2
    out["same_tokens_ff8_ff0"] = ids[8] == ids[0]
    log(f"[parse] ff=8 and ff=0 emit the same tokens: {out['same_tokens_ff8_ff0']}")
    out["divergence"] = []
    ff_tokens = eng.fsm.forced_tables(8)[0] if ids[8] != ids[0] else None
    for text, a, b in zip(UTTERANCES, ids[8], ids[0]):
        if a == b:
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        prompt_ids = eng.tokenizer.encode(_bench_prompt(eng, text), bos=True)
        state = max(eng.fsm.walk(a[:i]), 0)
        d = {"text": text, "step": i, "ff8": a[i] if i < len(a) else None,
             "ff0": b[i] if i < len(b) else None,
             "ff8_forced": i < len(a) and int(ff_tokens[state][0]) == a[i],
             **_plain_top2(eng, prompt_ids, a[:i])}
        out["divergence"].append(d)
        log(f"[parse] {text!r}: ff=8 and ff=0 part at step {i} (ff=8 {d['ff8']}, "
            f"forced chain head: {d['ff8_forced']}; ff=0 {d['ff0']}); plain forward top-2 "
            f"{d['top2']}, margin {d['margin']:.6f}")
    del eng
    report["parse"] = out


def phase_golden(totals: dict, report: dict) -> None:
    """The distilled checkpoint on the card must reproduce the recorded JAX
    parses token for token."""
    import torch

    from tpu_voice_agent_torch import distilled

    # a float32 checkpoint: full-precision products, as the recording had
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = distilled.golden_records()
    bad = []
    with Counted("golden", totals) as c:
        parser = distilled.intent_engine_from(*distilled.load_distilled(device="cuda"),
                                              device="cuda")
        eng = parser.engine
        t0 = time.perf_counter()
        for rec in recs:
            resp = parser.parse(rec["text"], rec["context"])
            ids = parser.last_result.token_ids
            if ids != rec["token_ids"] or resp != rec["response"]:
                bad.append((rec, ids))
        wall = time.perf_counter() - t0
    c.require("flash_attention", "decode_attention_layer", "masked_argmax_advance")
    for rec, ids in bad:
        # the first differing step and the top-2 margin there
        i = next((j for j, (a, b) in enumerate(zip(ids, rec["token_ids"])) if a != b),
                 min(len(ids), len(rec["token_ids"])))
        prompt = eng.tokenizer.encode(distilled.distilled_prompt(rec["text"], rec["context"]),
                                      bos=True)
        d = _plain_top2(eng, prompt, rec["token_ids"][:i])
        log(f"[golden] MISMATCH {rec['text']!r} at step {i}: got "
            f"{ids[i] if i < len(ids) else None}, recorded "
            f"{rec['token_ids'][i] if i < len(rec['token_ids']) else None}; top-2 "
            f"{d['top2']} margin {d['margin']:.6f}")
    fail_if(bool(bad), f"golden: {len(bad)} of {len(recs)} parses differ from the recording")
    n_tok = sum(len(r["token_ids"]) for r in recs)
    log(f"[golden] {len(recs)} of {len(recs)} parses equal the recorded JAX output "
        f"({n_tok} tokens, {wall:.2f} s)")
    report["golden"] = {"cases": len(recs), "tokens": n_tok, "seconds": wall,
                        "launches": c.counts}


def _to_float(tree):
    """A float32 copy of a (nested dict / list) param tree."""
    if isinstance(tree, dict):
        return {k: _to_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_float(v) for v in tree]
    return tree.float()


# transcribes timed per bucket, few for the script's time limit: the B = 1
# transcribe is timed again by the voice loop and by stt_batch's 11-item
# reference
STT_WALL_RUNS = 1  # a depth the script's time limit sets


def phase_stt(totals: dict, report: dict):
    """whisper-large-v3 as bench.py builds it (buckets 300 and 1000, 32 new
    tokens, random bf16 weights, the in-tree 619-token vocabulary) on the
    card: per bucket the transcribe p50 over STT_WALL_RUNS runs, split into encode (to
    the encoder's completion) and decode ms, with tokens and forwards; one
    incremental feed + decode; the first decoder step through K5 held
    against the same step through K5's plain version (fp32 weights)."""
    import numpy as np
    import torch

    from tpu_voice_agent_torch.models.whisper import decoder_forward, init_self_cache, param_count
    from tpu_voice_agent_torch.serve.stt import SpeechEngine
    from tpu_voice_agent_torch.voicebench import synth_utterance

    t0 = time.perf_counter()
    eng = SpeechEngine("whisper-large-v3", frame_buckets=(300, 1000), max_new_tokens=32)
    torch.cuda.synchronize()
    cfg = eng.cfg
    log(f"[stt] boot {time.perf_counter() - t0:.2f} s: whisper-large-v3 d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim}, {cfg.enc_layers}+{cfg.dec_layers} layers, "
        f"{cfg.n_mels} mels, V {cfg.vocab_size}, {param_count(cfg) / 1e9:.3f} B params "
        f"{eng._param_dtype}, device {eng.device}")
    fail_if(eng.device.type != "cuda", "speech engine not on the card")
    hop, sr = eng.mel_cfg.hop, eng.mel_cfg.sample_rate
    out = {"params": param_count(cfg), "buckets": {}}
    with Counted("stt", totals) as c:
        for bucket in eng.frame_buckets:
            audio = synth_utterance((bucket - 10) * hop / sr)  # fills the bucket
            eng.transcribe(audio)  # warm
            rs, walls = [], []
            for _ in range(STT_WALL_RUNS):
                t1 = time.perf_counter()
                rs.append(eng.transcribe(audio))
                walls.append((time.perf_counter() - t1) * 1e3)
            for r in rs:
                fail_if(not (0 < len(r.token_ids) <= 32
                             and all(0 <= t < cfg.vocab_size for t in r.token_ids)),
                        f"stt: bad token ids {r.token_ids}")
            fail_if(len({tuple(r.token_ids) for r in rs}) != 1, "stt: runs disagree")
            enc = [r.encode_ms for r in rs]
            dec = [r.decode_ms for r in rs]
            row = {"p50_ms": statistics.median(walls), "walls_ms": walls,
                   "encode_p50_ms": statistics.median(enc), "decode_p50_ms": statistics.median(dec),
                   "tokens": len(rs[0].token_ids), "forwards": rs[0].forwards,
                   "ms_per_forward": statistics.median(dec) / rs[0].forwards,
                   "n_frames": rs[0].n_frames}
            out["buckets"][bucket] = row
            log(f"[stt] bucket {bucket} ({rs[0].n_frames} frames): transcribe p50 "
                f"{row['p50_ms']:.2f} ms (walls {[round(w, 2) for w in walls]}), encode p50 "
                f"{row['encode_p50_ms']:.2f} ms, decode p50 {row['decode_p50_ms']:.2f} ms, "
                f"tokens {row['tokens']}, forwards {row['forwards']}, "
                f"{row['ms_per_forward']:.3f} ms/forward")
        audio = synth_utterance(1.6)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = eng.incremental_feed(eng.incremental_init(), audio)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        r = eng.incremental_decode(st)
        out["incremental"] = {"blocks": st.consumed_frames // eng.INC_STEP,
                              "enc_len": st.enc_len, "feed_ms": (t2 - t1) * 1e3,
                              "decode_ms": r.decode_ms, "tokens": len(r.token_ids)}
        log(f"[stt] incremental: {out['incremental']['blocks']} blocks (enc_len {st.enc_len}) "
            f"fed in {(t2 - t1) * 1e3:.2f} ms, decode {r.decode_ms:.2f} ms, "
            f"{len(r.token_ids)} tokens")
    c.require("flash_attention", "decode_attention")

    # the prompt step (T = 1) at full width through K5 against the same step
    # with K5's plain version in its place, on fp32 copies of the weights
    # (in bf16 an attention output one ulp apart compounds over 32 random
    # layers): fp32 sums in another order only, so 1e-4 of the largest
    # logit, the CPU parity tests' fp32 bound
    from tpu_voice_agent_torch.models import whisper as whisper_mod
    from tpu_voice_agent_torch.models.whisper import compute_cross_kv, encoder_forward
    from tpu_voice_agent_torch.ops import decode_attention_reference

    p32 = _to_float(eng.params)
    audio = synth_utterance(2.9)
    padded = np.zeros(300 * hop, np.float32)
    padded[:len(audio)] = audio
    mel = eng._mel(padded)[None, :300]
    ckv = compute_cross_kv(p32, cfg, encoder_forward(p32, cfg, mel))
    enc_len = torch.tensor([len(audio) // hop // 2], dtype=torch.int32, device=eng.device)
    bos = torch.tensor([[eng.bos_ids[0]]], dtype=torch.int32, device=eng.device)
    pos = torch.zeros((1, 1), dtype=torch.int32, device=eng.device)
    logits = {}
    kernel = whisper_mod.decode_attention
    for impl, attend in (("kernel", kernel), ("plain", decode_attention_reference)):
        whisper_mod.decode_attention = attend
        try:
            cache = init_self_cache(cfg, 1, dtype=torch.float32, device=eng.device)
            logits[impl], _ = decoder_forward(p32, cfg, bos, pos, cache, ckv, enc_len)
        finally:
            whisper_mod.decode_attention = kernel
    del p32, ckv
    err = float((logits["kernel"] - logits["plain"]).abs().max())
    scale = float(logits["plain"].abs().max())
    log(f"[stt] first step (fp32 weights) through K5 vs its plain version: max|d logits| "
        f"{err:.4g} of max|logit| {scale:.4g} (tolerance 1e-4 of it)")
    fail_if(not (bool(torch.isfinite(logits["kernel"]).all()) and err <= 1e-4 * scale),
            "stt: the decoder step through K5 disagrees with its plain version")
    out["first_step_logit_err"] = err
    out["launches"] = c.counts
    out["quality"] = _stt_lanes(eng)
    report["stt"] = out
    return eng


def phase_stt_golden(totals: dict, report: dict) -> None:
    """Both in-repo Whisper checkpoints on the card must reproduce the
    recorded JAX transcripts token for token (fp32, head dim 16: K1 and K5
    in fp32)."""
    import torch

    from tpu_voice_agent_torch import whisper_ckpt

    # float32 checkpoints: full-precision products, as the recording had
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = whisper_ckpt.golden_records()
    bad, n, t0 = [], 0, time.perf_counter()
    with Counted("stt_golden", totals) as c:
        for name in whisper_ckpt.CHECKPOINTS:
            eng = whisper_ckpt.whisper_engine_from(
                *whisper_ckpt.load_whisper(name, device="cuda"), device="cuda")
            fail_if(eng._param_dtype != torch.float32 or eng.cfg.head_dim != 16,
                    f"{name}: expected fp32 weights of head dim 16")
            for rec in recs[name]:
                res = eng.transcribe(whisper_ckpt.render_speech(rec["text"]))
                n += 1
                if res.token_ids != rec["token_ids"]:
                    bad.append((name, rec["text"], res.token_ids, rec["token_ids"]))
    c.require("flash_attention", "decode_attention")
    for name, text, got, want in bad:
        log(f"[stt_golden] MISMATCH {name} {text!r}: got {got}, recorded {want}")
    fail_if(bool(bad), f"stt_golden: {len(bad)} of {n} transcripts differ from the recording")
    wall = time.perf_counter() - t0
    log(f"[stt_golden] {n} of {n} transcripts equal the recorded JAX token ids "
        f"({', '.join(whisper_ckpt.CHECKPOINTS)}; {wall:.2f} s)")
    report["stt_golden"] = {"cases": n, "seconds": wall, "launches": c.counts}


# utterances of the random-weight voice loop, fewer than bench.py's 9 for the
# script's time limit: each is ~5 s of random large-v3 partials, and
# voice_service then drives the same loop through the service
VOICE_LOOP_RUNS = 1
VOICE_NEURAL_RUNS = 3  # bench.py runs 9; a depth the script's time limit sets


def phase_voice(stt_engine, totals: dict, report: dict) -> None:
    """bench.py's voice→intent loop on the port at full width:
    whisper-large-v3 STT (buckets 300 and 1000, 32 tokens) and the
    tinyllama-1.1b int8 ff=8 parse behind the cached prefix (cache 1024),
    colocated on the card, 3 utterances of synth_utterance(2.0) fed in 60 ms
    frames at real-time deadlines; then bench.py's --neural loop
    (``voicebench.run_neural_voice_bench``): the distilled parser and
    whisper-tiny-heldout, the acoustic-font renders of five eval texts, 9
    runs, each run's WER against the text it spoke."""
    import torch

    from tpu_voice_agent_torch import voicebench

    if stt_engine is None:
        stt_engine = voicebench.make_stt_engine()
    # built before the counts are zeroed: its prefix prefill runs K1, which
    # must come from the loop's own encoder and parse prefills below
    parse = voicebench.make_parse_engine()
    fail_if(parse.device.type != "cuda" or parse.quant != "int8" or parse.fast_forward != 8,
            "voice: parse engine not at int8 ff=8 on the card")
    with Counted("voice", totals) as c:
        res = voicebench.run_voice_bench(parse, stt_engine, runs=VOICE_LOOP_RUNS)
    c.require("flash_attention", "decode_block_attention_layer", "masked_argmax_advance",
              "decode_attention")
    for key in ("p50_ms", "p95_ms", "stt_p50_ms", "parse_p50_ms"):
        fail_if(not (math.isfinite(res[key]) and res[key] > 0), f"voice: {key} {res[key]}")
    log(f"[voice] e2e runs (ms): {[round(x, 1) for x in res['e2e_ms']]}")
    log(f"[voice] voice->intent p50 {res['p50_ms']:.2f} ms, p95 {res['p95_ms']:.2f} ms over "
        f"{res['runs']} runs; STT (end of speech -> final) p50 {res['stt_p50_ms']:.2f} ms; "
        f"post-endpoint parse p50 {res['parse_p50_ms']:.2f} ms; spec hit rate "
        f"{res['spec_hit_rate']:.3f}; early close rate {res['early_close_rate']:.3f} "
        f"({res['early_closes']} early / {res['window_closes']} full window); feed lag at "
        f"end of speech {[round(x, 3) for x in res['feed_lag_at_end_of_speech_s']]} s; parse "
        f"tokens {res['parse_tokens']}")
    report["voice"] = {**res, "launches": c.counts}
    del parse

    # the trained checkpoints are fp32: no tf32 in their matmuls or convs
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        nparser, nstt, name = voicebench.make_neural_engines()
        with Counted("voice_neural", totals) as c:
            nres = voicebench.run_neural_voice_bench(nparser, nstt, runs=VOICE_NEURAL_RUNS)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    c.require("flash_attention", "decode_attention_layer", "masked_argmax_advance",
              "decode_attention")
    fail_if(not all(math.isfinite(nres[k]) and nres[k] > 0 for k in ("p50_ms", "p95_ms")),
            f"voice neural: p50 {nres['p50_ms']} p95 {nres['p95_ms']}")
    fail_if(len(nres["wer"]) != VOICE_NEURAL_RUNS or not all(0 <= w for w in nres["wer"]),
            f"voice neural: WER {nres['wer']}")
    log(f"[voice] neural ({name} + the distilled parser): voice->intent p50 "
        f"{nres['p50_ms']:.2f} ms, p95 {nres['p95_ms']:.2f} ms over {nres['runs']} runs; "
        f"STT p50 {nres['stt_p50_ms']:.2f} ms, parse p50 {nres['parse_p50_ms']:.2f} ms, spec "
        f"hit rate {nres['spec_hit_rate']:.3f}; WER per run "
        f"{[round(w, 4) for w in nres['wer']]}, mean {nres['wer_mean']:.4f}; finals "
        f"{nres['finals']}")
    report["voice"]["neural"] = {**nres, "stt_checkpoint": name, "launches": c.counts}


# ------------------------------------------------------------------ voice service

# the JAX service's event vocabulary (tpu_voice_agent/services/voice.py)
VOICE_EVENTS = {"transcript_partial", "transcript_final", "intent", "tts", "execution_result",
                "execution_error", "confirmation_required", "latency_budget", "info", "warn",
                "error"}
# synth_utterance(2.0) + 1 s of silence each. voicebench runs 9, but at
# SpeechEngine's defaults (64 new tokens) random large-v3 weights decode every
# partial to the budget and the service falls ~16 s behind an utterance (a
# 9-utterance run drained 146.7 s after the last frame): 1, for the script's
# time limit; stt_batch's service run drives it through the service on 3
# connections
VOICE_AUDIO_UTTERANCES = 1
# voice_service's locked plane: 1, for the script's time limit (each utterance
# adds ~20 s of drain behind the paced audio)
VOICE_LOCKED_UTTERANCES = 1
# typed behind the distilled brain, whose intents are recorded
# (intent_golden.json): one safe command, and one whose upload and click both
# need confirmation
VOICE_TRAINED_COMMANDS = ("scroll down", "upload my cover letter and submit it")


def _stub_executor():
    """A stdlib /execute: a session id (the caller's, or a new one) and one
    {"ok": true} result an intent. Returns (server, thread, url, log)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    received: list[dict] = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
            if self.path != "/execute":
                status, out = 404, {"error": "not_found"}
            else:
                received.append(body)
                status = 200
                out = {"session_id": body.get("session_id") or f"stub-session-{len(received)}",
                       "results": [{"ok": True} for _ in body.get("intents") or []]}
            data = json.dumps(out).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):
            pass

    return (*_serve(ThreadingHTTPServer(("127.0.0.1", 0), Handler)), received)


def _check_vocabulary(events: list, label: str) -> None:
    bad = [e for e in events if e.get("type") not in VOICE_EVENTS]
    fail_if(bool(bad), f"{label}: frames outside the vocabulary: {bad[:3]}")
    degraded = [e for e in events if e.get("degraded")]
    fail_if(bool(degraded), f"{label}: degraded frames (a brain 5xx or transport fault "
                            f"served by the rule fallback): {degraded[:3]}")


def _check_finals(events: list, label: str) -> None:
    """No error or execution_error frame, and every transcript_final has its
    intent before the next final (handle_final sends both in turn)."""
    errors = [e for e in events if e["type"] in ("error", "execution_error")]
    fail_if(bool(errors), f"{label}: {errors[:3]}")
    kinds = [e["type"] for e in events if e["type"] in ("transcript_final", "intent")]
    fail_if(kinds != ["transcript_final", "intent"] * (len(kinds) // 2),
            f"{label}: finals and intents out of turn: {kinds}")


def _check_command(text: str, fr: list, label: str) -> tuple[dict, list]:
    """One typed command's frames: its transcript_final, then a non-degraded
    intent that passes ParseResponse validation; confirmation_required for
    exactly its risky intents; one execution_result, every result ok, when
    it has safe intents that are not ``unknown``; no error; latency_budget
    last. Returns (the plan, its safe intents)."""
    from tpu_voice_agent_torch.schemas import is_risky, validate_parse_response

    _check_vocabulary(fr, f"{label} {text!r}")
    types = [f["type"] for f in fr]
    fail_if(fr[0] != {"type": "transcript_final", "text": text} or types[1:2] != ["intent"],
            f"{label} {text!r}: expected transcript_final then intent, got {fr[:2]}")
    plan = fr[1]["data"]
    fail_if(validate_parse_response(plan) != (plan, None),
            f"{label} {text!r}: intent fails ParseResponse validation: {plan}")
    risky = [i for i in plan["intents"] if is_risky(i)]
    safe = [i for i in plan["intents"] if not is_risky(i) and i["type"] != "unknown"]
    confs = [f for f in fr if f["type"] == "confirmation_required"]
    fail_if([f["intents"] for f in confs] != ([risky] if risky else []),
            f"{label} {text!r}: confirmation_required {confs} for risky {risky}")
    execs = [f for f in fr if f["type"] == "execution_result"]
    fail_if(len(execs) != (1 if safe else 0)
            or any(len(f["data"]["results"]) != len(safe)
                   or not all(r.get("ok") for r in f["data"]["results"]) for f in execs),
            f"{label} {text!r}: execution_result {execs} for safe {safe}")
    fail_if(types[-1] != "latency_budget" or "error" in types or "execution_error" in types,
            f"{label} {text!r}: frames {types}")
    return plan, safe


def _pcm_frames(audio, frame_ms: int = 60) -> list[bytes]:
    import numpy as np

    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    step = 16_000 * frame_ms // 1000 * 2
    return [pcm[i:i + step] for i in range(0, len(pcm), step)]


async def _stream_paced(url: str, frames: list[bytes], timeout_s: float = 600.0) -> dict:
    """Send 60 ms frames at their real-time deadlines on one /stream while a
    reader collects every frame; then a context_update marks the end of the
    audio (frames are handled in order), and the read goes on until every
    transcript_final has its latency_budget."""
    from tpu_voice_agent_torch.services import ws

    c = await ws.connect(url + "/stream")
    events: list = []

    async def reader():
        while True:
            msg = await c.receive()
            if msg.type != ws.TEXT:
                return
            events.append(msg.json())

    task = asyncio.ensure_future(reader())
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        await asyncio.sleep(max(0.0, t0 + i * 0.06 - time.perf_counter()))
        await c.send_bytes(f)
    t_sent = time.perf_counter()
    await c.send_json({"type": "context_update", "data": {}})
    end = time.monotonic() + timeout_s
    while True:
        marked = any(e.get("message") == "context updated" for e in events)
        finals = sum(e["type"] == "transcript_final" for e in events)
        budgets = sum(e["type"] == "latency_budget" for e in events)
        if marked and budgets >= finals:
            break
        fail_if(task.done() or time.monotonic() > end,
                f"voice_service: stream ended or stalled ({finals} finals, {budgets} budgets)")
        await asyncio.sleep(0.05)
    t_done = time.perf_counter()
    await c.close()
    task.cancel()
    return {"events": events, "audio_s": t_sent - t0, "drained_s": t_done - t_sent}


async def _typed_commands(url: str, texts: list[str], min_execs: int = 2) -> tuple:
    """One /stream: each text frame, read to its latency_budget (the last
    frame of a command); then, if fewer than ``min_execs`` commands were
    executed, confirm_execute frames of a screenshot on the same stream, each
    read to its execution_result, so the session threading is still seen."""
    from tpu_voice_agent_torch.services import ws

    c = await ws.connect(url + "/stream")
    greeting = (await c.receive(timeout=60)).json()
    per, confirms = [], []

    async def read_until(kind: str) -> list:
        got = []
        while not any(f["type"] == kind for f in got):
            msg = await c.receive(timeout=600)
            fail_if(msg.type != ws.TEXT, f"voice_service: the stream closed: {msg}")
            got.append(msg.json())
        return got

    for text in texts:
        await c.send_json({"type": "text", "text": text})
        per.append(await read_until("latency_budget"))
    execs = sum(f["type"] == "execution_result" for fr in per for f in fr)
    for _ in range(max(0, min_execs - execs)):
        await c.send_json({"type": "confirm_execute", "intents": [{"type": "screenshot"}]})
        confirms.append(await read_until("execution_result"))
    await c.close()
    return greeting, per, confirms


def _p(xs: list, q: float):
    """voicebench's percentile (numpy's, interpolated); None for no samples."""
    import numpy as np

    return float(np.percentile(xs, q * 100)) if xs else None


def _voice_boot(brain_url: str, exec_url: str):
    """The port's voice service from the environment (VOICE_STT), on an
    ephemeral port; fails if its STT engine did not land on the card."""
    from tpu_voice_agent_torch.services import voice, ws

    cfg = voice.VoiceConfig(brain_url=brain_url, executor_url=exec_url)
    probe = cfg.stt_factory()
    fail_if(probe.engine.device.type != "cuda",
            f"voice_service: the STT engine booted on {probe.engine.device}")
    return ws.ServerThread(voice.build_app(cfg)).__enter__(), probe.engine


def _health(url: str) -> dict:
    with urllib.request.urlopen(url + "/health", timeout=60) as r:
        return json.loads(r.read())


def phase_voice_service(totals: dict, report: dict) -> None:
    """The port's voice WS service on the card, driven through its own
    client (``services/ws.py``): the tinyllama-1.1b int8 ff 8 brain behind
    the cached prefix and a stub executor in-process, the voice service at
    VOICE_STT=whisper:whisper-large-v3 (random weights, SpeechEngine's
    defaults). Real-time paced audio (K1, K5), the five typed commands (K3,
    K4) through the confirmation gate and the executor's session, then
    the trained checkpoints (whisper-tiny-overfit STT, the distilled brain)
    reading "search for red shoes" (K1, K2, K4, K5) to its executed search,
    and two typed commands whose recorded intents take one through the
    executor and one through confirmation_required. Any error or
    execution_error frame, a final without its intent, or a degraded frame
    fails the phase."""
    import numpy as np
    import torch

    from tpu_voice_agent_torch import distilled, voicebench, whisper_ckpt
    from tpu_voice_agent_torch.schemas import is_risky, validate_intent
    from tpu_voice_agent_torch.services import brain

    out: dict = {}
    os.environ.update(BRAIN_BACKEND="engine:tinyllama-1.1b", BRAIN_QUANT="int8",
                      VOICE_STT="whisper:whisper-large-v3")
    for k in ("BRAIN_FF", "BRAIN_PREFIX", "BRAIN_DEVICE", "BRAIN_BATCH", "VOICE_DEVICE",
              "QUALITY_ENABLE", "STT_BATCH_ENABLE", "STT_BATCH_SLOTS", "STT_REPLICAS",
              "CHAOS_FAULTS"):
        os.environ.pop(k, None)
    t0 = time.perf_counter()
    parser = brain.make_parser_from_env()
    eng = parser.engine
    fail_if(eng.device.type != "cuda" or eng.kernels != "kernels" or eng.fast_forward != 8
            or eng.quant != "int8" or not eng.prefix_ids,
            "voice_service: brain not on the card at int8 / ff 8 / cached prefix")
    bsrv, bthread, brain_url = _serve_brain(brain.BrainApp(parser))
    xsrv, xthread, exec_url, received = _stub_executor()
    vsrv, stt = _voice_boot(brain_url, exec_url)
    out["boot_s"] = time.perf_counter() - t0
    log(f"[voice_service] boot {out['boot_s']:.2f} s: brain {eng.cfg.n_layers} layers int8 ff 8 "
        f"on {eng.device}, STT {stt.cfg.d_model} wide, {stt.cfg.enc_layers}+"
        f"{stt.cfg.dec_layers} layers, {stt._param_dtype} on {stt.device}, buckets "
        f"{stt.frame_buckets}, {stt.max_new_tokens} new tokens")
    try:
        # 1. audio at real-time pace
        sil = np.zeros(16_000, dtype=np.float32)
        audio = np.concatenate([x for _ in range(VOICE_LOCKED_UTTERANCES)
                                for x in (voicebench.synth_utterance(2.0), sil)])
        from tpu_voice_agent_torch.utils import chaos
        from tpu_voice_agent_torch.utils.tracing import get_metrics

        def dropped():
            return get_metrics().snapshot()["counters"].get("voice.frames_dropped_chaos", 0.0)

        dropped0 = dropped()
        chaos.configure("drop_frame@5")  # one frame lost: the transcript may differ
        try:
            with Counted("voice_service_audio", totals) as c:
                res = asyncio.run(_stream_paced(vsrv.url, _pcm_frames(audio)))
        finally:
            chaos.reset()
        c.require("flash_attention", "decode_attention")
        fail_if(dropped() - dropped0 != 1,
                f"voice_service: drop_frame@5 dropped {dropped() - dropped0} frames, want 1")
        events = res["events"]
        _check_vocabulary(events, "voice_service audio")
        _check_finals(events, "voice_service audio")
        budgets = [e["stages"] for e in events if e["type"] == "latency_budget"]
        finals = [e["text"] for e in events if e["type"] == "transcript_final"]
        stages = {k: [b[k] for b in budgets if k in b]
                  for k in ("stt_finalize_ms", "parse_ms", "total_ms")}
        out["audio"] = {
            "utterances": VOICE_LOCKED_UTTERANCES, "finals": len(finals),
            "partials": sum(e["type"] == "transcript_partial" for e in events),
            "audio_s": res["audio_s"], "drained_after_audio_s": res["drained_s"],
            **{f"{k[:-3]}_p{q}_ms": _p(v, q / 100) for k, v in stages.items()
               for q in (50, 95)},
            "launches": c.counts}
        log(f"[voice_service] audio: {len(finals)} finals of {VOICE_LOCKED_UTTERANCES} "
            f"utterances ({out['audio']['partials']} partials), audio sent over "
            f"{res['audio_s']:.2f} s, drained {res['drained_s']:.2f} s later; finals "
            f"{[f[:40] for f in finals]}; stages p50/p95 (ms): " + ", ".join(
                f"{k} {_p(v, 0.5)} / {_p(v, 0.95)}" for k, v in stages.items()))

        # 2. typed commands through the gate
        received.clear()
        with Counted("voice_service_typed", totals) as c:
            greeting, per, confirms = asyncio.run(_typed_commands(vsrv.url, UTTERANCES))
        # the brain's prompt is a suffix behind the cached prefix: the plain
        # cache attention prefills it, as in JAX, so K1 runs here only in the
        # prefix's own prefill at boot (and in the audio's Whisper encoder)
        c.require("decode_block_attention_layer", "masked_argmax_advance")
        fail_if(greeting != {"type": "info", "message": "listening"},
                f"voice_service: greeting {greeting}")
        parse_ms, kinds, want = [], [], []
        for text, fr in zip(UTTERANCES, per):
            plan, safe = _check_command(text, fr, "voice_service")
            parse_ms.append(fr[-1]["stages"]["parse_ms"])
            kinds.append([i["type"] for i in plan["intents"]])
            if safe:
                want.append(safe)
        for fr in confirms:
            execs = [f for f in fr if f["type"] == "execution_result"]
            fail_if(any(f["type"] in ("error", "execution_error", "warn") for f in fr)
                    or [r.get("ok") for r in execs[0]["data"]["results"]] != [True],
                    f"voice_service confirm_execute: frames {fr}")
        want += [[validate_intent({"type": "screenshot"})]] * len(confirms)
        got = [b["intents"] for b in received]
        fail_if(got != want, f"voice_service: the executor received {got}, the gate let "
                             f"through {want}")
        sids = [b["session_id"] for b in received]
        fail_if(len(sids) < 2 or sids[0] is not None
                or any(s != "stub-session-1" for s in sids[1:]),
                f"voice_service: session ids sent to /execute {sids} (the first answer, "
                "stub-session-1, must be threaded into every later call)")
        health = _health(vsrv.url)
        fail_if(health["status"] != "ok" or set(health["breakers"].values()) != {"closed"},
                f"voice_service: /health {health}")
        voice_parse = report.get("voice", {}).get("parse_p50_ms")
        out["typed"] = {"intent_types": kinds, "executions": len(received),
                        "confirm_screenshots": len(confirms), "session_ids": sids,
                        "parse_p50_ms": _p(parse_ms, 0.5), "parse_ms": parse_ms,
                        "voice_phase_parse_p50_ms": voice_parse, "health": health,
                        "launches": c.counts}
        log(f"[voice_service] typed: intents {kinds}; {len(received)} executions "
            f"({len(confirms)} confirmed screenshots), session ids {sids}; parse ms "
            f"{[round(x, 1) for x in parse_ms]}, p50 {_p(parse_ms, 0.5)} (the voice phase's "
            f"in-process parse p50: {voice_parse}); /health {health['status']} "
            f"{health['breakers']}")
    finally:
        vsrv.__exit__(None, None, None)
        _stop(bsrv, bthread)
    del parser, eng, stt, vsrv, bsrv
    _free_cuda()

    # 3. trained weights: whisper-tiny-overfit and the distilled brain booted
    # from the environment (BRAIN_BACKEND=distilled, QUALITY_ENABLE unset:
    # the lanes on), fp32: the spoken search, then typed commands with
    # recorded intents through the confirmation gate; every final carries
    # its confidence and every parse its x-intent-margin, each equal to the
    # same stack run on the CPU; the metrics, trace and quality routes of
    # both services scraped and held to the run's counts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(VOICE_STT="whisper-ckpt:checkpoints/whisper-tiny-overfit",
                      BRAIN_BACKEND="distilled")
    os.environ.pop("BRAIN_QUANT", None)
    text = "search for red shoes"
    audio = np.concatenate([whisper_ckpt.render_speech(text), np.zeros(16_000, np.float32)])
    parser = brain.make_parser_from_env()
    fail_if(not isinstance(parser, brain.EngineParser) or parser.engine.device.type != "cuda"
            or not parser.engine.quality_lanes,
            "voice_service trained: BRAIN_BACKEND=distilled did not boot the distilled "
            "engine on the card with the quality lanes on")
    bsrv, bthread, brain_url = _serve_brain(brain.BrainApp(parser))
    vsrv, _stt = _voice_boot(brain_url, exec_url)
    try:
        before = {"brain": _scrape(brain_url), "voice": _scrape(vsrv.url)}
        received.clear()
        with Counted("voice_service_trained", totals) as c:
            res = asyncio.run(_stream_paced(vsrv.url, _pcm_frames(audio)))
        c.require("flash_attention", "decode_attention_layer", "masked_argmax_advance",
                  "decode_attention")
        events = res["events"]
        _check_vocabulary(events, "voice_service trained")
        _check_finals(events, "voice_service trained")
        finals = [e["text"] for e in events if e["type"] == "transcript_final"]
        intents = [e["data"]["intents"] for e in events if e["type"] == "intent"]
        fail_if(finals != [text], f"voice_service trained: finals {finals}")
        fail_if(not intents or intents[0][0]["type"] != "search"
                or intents[0][0]["args"].get("query") != "red shoes",
                f"voice_service trained: intents {intents}")
        safe = [i for i in intents[0] if not is_risky(i) and i["type"] != "unknown"]
        execs = [e["data"]["results"] for e in events if e["type"] == "execution_result"]
        fail_if(execs != [[{"ok": True}] * len(safe)],
                f"voice_service trained: execution results {execs} for safe {safe}")
        fail_if([b["intents"] for b in received] != [safe],
                f"voice_service trained: the executor received {received}, want {[safe]}")
        budget = next(e for e in events if e["type"] == "latency_budget")

        recs = {r["text"]: r for r in distilled.golden_records()}
        received.clear()
        with Counted("voice_service_trained_typed", totals) as c2:
            greeting, per, _ = asyncio.run(
                _typed_commands(vsrv.url, list(VOICE_TRAINED_COMMANDS), min_execs=0))
        c2.require("flash_attention", "decode_attention_layer", "masked_argmax_advance")
        fail_if(greeting != {"type": "info", "message": "listening"},
                f"voice_service trained: greeting {greeting}")
        want, confirmed = [], []
        for cmd, fr in zip(VOICE_TRAINED_COMMANDS, per):
            plan, cmd_safe = _check_command(cmd, fr, "voice_service trained")
            fail_if(plan["intents"] != recs[cmd]["response"]["intents"],
                    f"voice_service trained {cmd!r}: intents {plan['intents']}, recorded "
                    f"{recs[cmd]['response']['intents']}")
            if cmd_safe:
                want.append(cmd_safe)
            confirmed += [f["intents"] for f in fr if f["type"] == "confirmation_required"]
        # the recordings hold one safe command and one risky one: both gates ran
        fail_if(not want or not confirmed,
                f"voice_service trained: executed {want}, confirmations {confirmed}")
        fail_if([b["intents"] for b in received] != want,
                f"voice_service trained: the executor received {received}, the gate let "
                f"through {want}")
        card = _confidence_and_margins(events, per, "voice_service trained")
        scraped = _check_scrapes(brain_url, vsrv.url, before, budget["trace_id"],
                                 n_audio=len(finals), n_typed=len(per))
        out["trained"] = {"final": finals[0], "intent": intents[0], "stages": budget["stages"],
                          "launches": c.counts, "typed": {
                              cmd: [f["type"] for f in fr]
                              for cmd, fr in zip(VOICE_TRAINED_COMMANDS, per)},
                          "typed_launches": c2.counts, "quality": card, "scraped": scraped}
        log(f"[voice_service] trained: final {finals[0]!r} -> {intents[0]}; stages "
            f"{budget['stages']}; typed {out['trained']['typed']}; confidence "
            f"{card['confidence']}; intent margins {card['margins']}")
    finally:
        vsrv.__exit__(None, None, None)
        _stop(bsrv, bthread)
    del parser

    # the same stack on the CPU (the plain versions), the same audio and commands
    os.environ.update(BRAIN_DEVICE="cpu", VOICE_DEVICE="cpu")
    try:
        from tpu_voice_agent_torch.services import voice, ws

        cbsrv, cbthread, cbrain_url = _serve_brain(brain.BrainApp(brain.make_parser_from_env()))
        cvsrv = ws.ServerThread(voice.build_app(voice.VoiceConfig(
            brain_url=cbrain_url, executor_url=exec_url))).__enter__()
    finally:
        for k in ("BRAIN_DEVICE", "VOICE_DEVICE", "VOICE_STT", "BRAIN_BACKEND"):
            os.environ.pop(k, None)
    try:
        cres = asyncio.run(_stream_paced(cvsrv.url, _pcm_frames(audio)))
        _g, cper, _ = asyncio.run(
            _typed_commands(cvsrv.url, list(VOICE_TRAINED_COMMANDS), min_execs=0))
        cpu = _confidence_and_margins(cres["events"], cper, "voice_service trained (CPU)")
    finally:
        cvsrv.__exit__(None, None, None)
        _stop(cbsrv, cbthread)
        _stop(xsrv, xthread)
    diffs = [abs(a[k] - b[k]) for a, b in zip(card["confidence"], cpu["confidence"])
             for k in a] + [abs(a - b) for a, b in zip(card["margins"], cpu["margins"])]
    fail_if(len(card["confidence"]) != len(cpu["confidence"])
            or len(card["margins"]) != len(cpu["margins"])
            or any(set(a) != set(b) for a, b in zip(card["confidence"], cpu["confidence"]))
            or max(diffs) > QUALITY_CPU_TOL,
            f"voice_service trained: the card's lanes {card} against the CPU's {cpu} "
            f"(tolerance {QUALITY_CPU_TOL:g})")
    out["trained"]["cpu"] = {**cpu, "max_abs_err": max(diffs)}
    log(f"[voice_service] trained on the CPU: confidence {cpu['confidence']}, margins "
        f"{cpu['margins']}; largest difference from the card {max(diffs):.3g} (tolerance "
        f"{QUALITY_CPU_TOL:g})")
    report["voice_service"] = out


def _confidence_and_margins(events: list, per: list, label: str) -> dict:
    """Every transcript_final's ``confidence`` (JAX's four keys, none
    missing with the lanes on) and every parse's ``intent_margin`` as the
    voice service folds x-intent-margin into the latency_budget stages."""
    confs = [e.get("confidence") for e in events if e["type"] == "transcript_final"]
    fail_if(any(c is None or set(c) != {"logp_mean", "logp_min", "logp_first", "repetition"}
                for c in confs), f"{label}: transcript_final confidence {confs}")
    budgets = [e["stages"] for e in events if e["type"] == "latency_budget"]
    budgets += [f["stages"] for fr in per for f in fr if f["type"] == "latency_budget"]
    fail_if(any("intent_margin" not in b for b in budgets),
            f"{label}: a parse without x-intent-margin: {budgets}")
    return {"confidence": confs, "margins": [b["intent_margin"] for b in budgets]}


def _scrape(url: str) -> dict:
    """One service's ``/metrics`` (JSON) and ``/debug/quality``."""
    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return json.loads(r.read())

    return {"metrics": get("/metrics"), "quality": get("/debug/quality")}


def _check_scrapes(brain_url: str, voice_url: str, before: dict, trace_id: str,
                   n_audio: int, n_typed: int) -> dict:
    """Both services' /metrics (JSON and Prometheus text), /debug/quality
    and the audio utterance's /debug/trace/<id>, held to the run: one STT
    quality record per final, one intent record per parse, the brain's
    parses equal to the /parse calls the voice service made (its speculative
    parses and its parse round trips), and the voice.spec_parse_* outcomes
    adding up to the audio finals."""
    after = {"brain": _scrape(brain_url), "voice": _scrape(voice_url)}

    def delta(side, reg, kind, name):
        def value(scrape):
            v = scrape[side]["metrics"][reg][kind].get(name)
            return (v or {"count": 0})["count"] if kind == "latency_ms" else (v or 0)

        return value(after) - value(before)

    vq = after["voice"]["quality"]["counts"]
    bq = after["brain"]["quality"]["counts"]
    spec = {k: delta("voice", "runtime", "counters", f"voice.spec_parse_{k}")
            for k in ("started", "hit", "commit", "unsupported", "failed", "stale")}
    roundtrips = delta("voice", "local", "latency_ms", "voice.parse_roundtrip")
    brain_parses = spec["started"] + roundtrips
    fail_if(vq.get("quality.stt_finals") != n_audio,
            f"scrape: voice stt quality records {vq} for {n_audio} finals")
    fail_if(vq.get("quality.parses") != n_audio + n_typed,
            f"scrape: voice parse quality records {vq} for {n_audio + n_typed} finals")
    fail_if(spec["hit"] + spec["unsupported"] + spec["failed"] + spec["stale"] != n_audio,
            f"scrape: voice.spec_parse_* outcomes {spec} for {n_audio} audio finals")
    fail_if(bq.get("quality.parses") != brain_parses
            or delta("brain", "local", "latency_ms", "brain.parse") != brain_parses
            or delta("brain", "runtime", "counters", "engine.requests") != brain_parses,
            f"scrape: brain parses {bq}, brain.parse spans, engine.requests against "
            f"{brain_parses} (spec {spec}, round trips {roundtrips})")
    traces = {}
    for side, url in (("brain", brain_url), ("voice", voice_url)):
        with urllib.request.urlopen(f"{url}/debug/trace/{trace_id}", timeout=60) as r:
            traces[side] = [s["span"] for s in json.loads(r.read())["spans"]]
        req = urllib.request.Request(url + "/metrics", headers={"Accept": "text/plain"})
        with urllib.request.urlopen(req, timeout=60) as r:
            fail_if(not r.headers["Content-Type"].startswith("text/plain; version=0.0.4"),
                    f"scrape: {side} Prometheus content type {r.headers['Content-Type']}")
            prom = r.read().decode()
        fail_if("# TYPE quality_parses_total counter" not in prom,
                f"scrape: {side} Prometheus text without quality_parses_total")
    fail_if("parse" not in traces["brain"]
            or not {"audio_ingest", "stt_finalize"} <= set(traces["voice"]),
            f"scrape: trace {trace_id}: {traces}")
    log(f"[voice_service] scraped: voice quality counts {vq}, brain {bq}; spec outcomes "
        f"{spec}, parse round trips {roundtrips}; trace {trace_id}: {traces}")
    return {"voice_counts": vq, "brain_counts": bq, "spec": spec, "roundtrips": roundtrips,
            "trace": traces,
            "voice_quality_windows": after["voice"]["quality"]["windows"],
            "brain_quality_windows": after["brain"]["quality"]["windows"]}


# ------------------------------------------------------------------ batched /parse

BATCH_SLOTS = 32
BATCH_NEW_TOKENS = 128  # bench_batch.py's fallback plan budget (the p95 it names)


def _batch_prompt(i: int) -> str:
    """bench_batch.py's traffic: one command per session."""
    from tpu_voice_agent_torch.services.prompts import render_prompt

    return render_prompt(f"search for item {i} and sort by price", {})


def _paged_engine(params, ff: int, **kw):
    """bench_batch.py's paged shape: tinyllama-1.1b int8, 32 slots, max_len
    2048, prefill bucket 1024, block 128, the default 513-block pool, the
    bf16 pool unless ``kv_quant`` names a tier."""
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine

    kw = {"batch_slots": BATCH_SLOTS, "prefill_buckets": (1024,), "kv_quant": "off", **kw}
    eng = PagedDecodeEngine(preset="tinyllama-1.1b", quant="int8", fast_forward=ff,
                            max_len=2048, init_weights=False, **kw)
    eng.load_params(params)
    return eng


def _drain(eng, label: str, totals: dict, on_start=None, sessions: int = BATCH_SLOTS):
    """bench_batch.py's ``run_one`` on ``eng``: the cached prefix (installed
    here unless the engine has one), a ContinuousBatcher (chunk 16, 128 new
    tokens), one warm-up request, then ``sessions`` (32) sessions submitted
    at once and drained, stepping by hand to sample
    the pool's peak occupancy. Fails unless every session is ok and in the
    grammar and the pool is back to the prefix's blocks. ``on_start()``, if
    given, runs after the warm-up, just before the counted drain. Returns
    (row, results, launch counts)."""
    import torch

    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    P = len(eng.prefix_ids) or install_prompt_prefix(eng)
    prefix_blocks = eng.allocator.blocks_in_use
    fail_if(prefix_blocks != P // eng.block_size, f"{label}: prefix blocks not installed once")
    batcher = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS)
    batcher.submit(_batch_prompt(0))  # warm-up
    batcher.run_until_done()
    batcher.results.clear()
    chunks0, fwd0 = batcher.chunks, batcher.forwards
    if on_start is not None:
        on_start()
    with Counted(label, totals) as c:
        torch.cuda.synchronize()
        peak = 0
        t0 = time.perf_counter()
        rids = [batcher.submit(_batch_prompt(i)) for i in range(sessions)]
        while batcher.busy():
            batcher.step()
            peak = max(peak, eng.allocator.blocks_in_use)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = [batcher.results.pop(r) for r in rids]
    ok = sum(r.error is None for r in res)
    walks = [eng.fsm.walk(r.token_ids) for r in res]
    tokens = sum(r.steps for r in res)
    row = {"prefix_tokens": P, "sessions": sessions, "ok": ok, "wall_s": wall,
           "intents_per_s": sessions / wall, "tokens_per_s": tokens / wall,
           "tokens": tokens, "finished": sum(r.finished for r in res),
           "chunks": batcher.chunks - chunks0, "forwards": batcher.forwards - fwd0,
           "peak_pool_blocks": peak, "pool_blocks": eng.allocator.n_blocks,
           "blocks_after_drain": eng.allocator.blocks_in_use,
           "prefill_ms_p50": statistics.median(r.prefill_ms for r in res),
           "cached_tokens": sorted({r.cached_tokens for r in res}), "launches": c.counts}
    log(f"[{label}] {ok}/{sessions} ok ({row['finished']} reached EOS), "
        f"{tokens} tokens in {wall:.3f} s: {row['intents_per_s']:.3f} intents/s, "
        f"{row['tokens_per_s']:.1f} tokens/s; {row['chunks']} chunks, {row['forwards']} "
        f"forwards ({1e3 * wall / max(row['forwards'], 1):.2f} ms each with admissions); "
        f"peak pool {peak}/{eng.allocator.n_blocks} blocks, {row['blocks_after_drain']} "
        f"after the drain; suffix prefill p50 {row['prefill_ms_p50']:.2f} ms, cached "
        f"{row['cached_tokens']}")
    fail_if(ok != sessions, f"{label}: {sessions - ok} failed: "
            f"{[r.error for r in res if r.error][:3]}")
    fail_if(min(walks) < 0, f"{label}: a token stream left the grammar")
    fail_if(eng.allocator.blocks_in_use != prefix_blocks,
            f"{label}: {eng.allocator.blocks_in_use} blocks in use after the drain, "
            f"want the prefix's {prefix_blocks}")
    return row, res, c


def phase_batch(params, totals: dict, report: dict, profile: bool = False) -> None:
    """bench_batch.py's ``run_one`` on the port (bench_batch.py:72-144): the
    paged engine behind the cached prefix (``_drain``), at ff=8 (every step
    a (32, 9) block through K7) and ff=0 (T=1 steps through K6). Each
    session's token ids stay in the report for the kvquant phase."""
    out = {}
    for ff, kernel in ((8, "paged_block_attention"), (0, "paged_attention")):
        eng = _paged_engine(params, ff, radix_enable=False)
        row, res, c = _drain(eng, f"batch ff={ff}", totals)
        c.require(kernel, "masked_argmax_advance")
        row["token_ids"] = [r.token_ids for r in res]
        out[f"ff{ff}"] = row
        if profile:
            _profile_batch_chunk(eng, report, kind=f"ff{ff}")
        _KEPT[f"ff{ff}"] = eng  # the containment phase drills these engines
        del eng
    report["batch"] = out


def phase_kvquant(params, totals: dict, report: dict, profile: bool = False) -> None:
    """The KV_QUANT tiers of the batch cell: for int8 and int4, at ff=8
    (every chain step a (32, 9) block through K9) and ff=0 (T=1 steps
    through K8), ``_drain`` with the pool at the bf16 cell's byte budget
    (513 bf16 blocks: 994 int8, 1,931 int4). K6 and K7 must not launch. The
    sessions whose ids equal the bf16 drain's on the same weights are
    counted, with each parting step, and do not gate: random weights leave
    near-ties that a quantum of KV moves. Then the radix contract at int8
    with fp32 activations (4 sessions x 4 turns: radix on decodes what
    radix off decodes, within one bf16 ulp of the plain margin), and one
    ``/parse`` of a BRAIN_BATCH=32 BRAIN_PAGED=1 KV_QUANT=int8 brain, which
    must answer 200. ``profile``: one ff=8 and one ff=0 chunk per tier
    under the profiler."""
    import torch

    from tpu_voice_agent_torch.models.llama import PRESETS
    from tpu_voice_agent_torch.ops.kvquant import kv_block_bytes
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PRESETS["tinyllama-1.1b"]
    base = report.get("batch", {})
    out = {}
    for ff, kernel in ((8, "paged_block_attention_quant"), (0, "paged_attention_quant")):
        bf16_ids = base.get(f"ff{ff}", {}).get("token_ids")
        if bf16_ids is None:  # the batch phase did not run: the same drain, untimed
            eng = _paged_engine(params, ff, radix_enable=False)
            install_prompt_prefix(eng)
            bf16_ids = [r.token_ids for r in ContinuousBatcher(
                eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS).generate_many(
                [_batch_prompt(i) for i in range(BATCH_SLOTS)])]
            del eng
        for tier in ("int8", "int4"):
            label = f"kvquant {tier} ff={ff}"
            widths = (cfg.n_layers, 128, cfg.n_kv_heads, cfg.head_dim)
            blocks = 513 * kv_block_bytes(*widths, None) // kv_block_bytes(*widths, tier)
            eng = _paged_engine(params, ff, radix_enable=False, kv_quant=tier,
                                pool_blocks=blocks)
            row, res, c = _drain(eng, label, totals)
            c.require(kernel, "masked_argmax_advance")
            for bf in ("paged_attention", "paged_block_attention"):
                fail_if(c.counts.get(bf, 0) > 0, f"{label}: the bf16 kernel {bf} launched")
            parts = []
            for r, ids in zip(res, bf16_ids):
                if r.token_ids != ids:
                    parts.append(next((j for j, (x, y) in enumerate(zip(r.token_ids, ids))
                                       if x != y), min(len(ids), len(r.token_ids))))
            row.update(kv_bytes_per_block=eng.kv_bytes_per_block,
                       peak_pool_bytes=row["peak_pool_blocks"] * eng.kv_bytes_per_block,
                       pool_bytes=blocks * eng.kv_bytes_per_block,
                       same_as_bf16=BATCH_SLOTS - len(parts), parting_steps=parts,
                       token_ids=[r.token_ids for r in res])
            log(f"[{label}] {eng.kv_bytes_per_block} bytes a block, peak "
                f"{row['peak_pool_bytes']} of {row['pool_bytes']} pool bytes; "
                f"{row['same_as_bf16']} of {BATCH_SLOTS} sessions decode the bf16 drain's ids "
                f"(parting steps {parts})")
            out[f"{tier}_ff{ff}"] = row
            if profile:
                _profile_batch_chunk(eng, report, tier, kind=f"ff{ff}")
            del eng
    # the radix contract on the int8 pool, fp32 activations
    p = _fp32_activations(params)
    label = "kvquant radix int8 fp32"
    rows, prompts, hits, lookups, counts, wall, P = _radix_sessions(p, label, totals, "int8")
    diverged = _radix_off_divergence(p, prompts, label, "int8")
    _check_partings(diverged, label, 1)
    cached = [r["cached_tokens"] for r in rows]
    log(f"[{label}] 4 sessions x 4 turns in {wall:.2f} s: cached tokens per turn {cached} "
        f"(prefix {P}); tree hits {hits} of {lookups}; radix off decoded the same ids for "
        f"{len(prompts) - len(diverged)} of {len(prompts)} turns")
    out["radix_int8_fp32"] = {"prefix_tokens": P, "turns": rows, "seconds": wall, "hits": hits,
                              "lookups": lookups, "diverged": diverged, "launches": counts}
    del p
    out["service"] = _kvquant_service(totals)
    report["kvquant"] = out


def _kvquant_service(totals: dict) -> dict:
    """A BRAIN_BATCH=32 BRAIN_PAGED=1 KV_QUANT=int8 brain from the
    environment, in-process on an ephemeral port: one /parse must answer
    200 with a valid plan."""
    from tpu_voice_agent_torch.schemas import validate_parse_response
    from tpu_voice_agent_torch.services import brain

    env = dict(BRAIN_BACKEND="engine:tinyllama-1.1b", BRAIN_QUANT="int8", BRAIN_BATCH="32",
               BRAIN_PAGED="1", KV_QUANT="int8")
    os.environ.update(env)
    for k in ("BRAIN_FF", "BRAIN_PREFIX", "BRAIN_DEVICE", "BRAIN_POOL_BLOCKS", "BRAIN_CHUNK",
              "RADIX_ENABLE"):
        os.environ.pop(k, None)
    try:
        t0 = time.perf_counter()
        parser = brain.make_parser_from_env()
    finally:
        for k in ("BRAIN_BATCH", "BRAIN_PAGED", "KV_QUANT"):
            os.environ.pop(k, None)
    eng = parser.engine
    boot = time.perf_counter() - t0
    server, thread, base = _serve_brain(brain.BrainApp(parser))
    try:
        fail_if(not (isinstance(parser, brain.BatchedEngineParser) and eng.kv_quant == "int8"
                     and eng.batch_slots == 32 and eng.device.type == "cuda"),
                "kvquant service: not a batched int8-KV paged parser on the card")
        with Counted("kvquant service", totals) as c:
            t1 = time.perf_counter()
            status, body = _post(base, {"text": UTTERANCES[0], "context": {}})
            wall = time.perf_counter() - t1
    finally:
        _stop(server, thread)
        parser.close()
    c.require("paged_block_attention_quant", "masked_argmax_advance")
    fail_if(status != 200 or validate_parse_response(body) != (body, None),
            f"kvquant service: /parse answered {status} {body}")
    log(f"[kvquant service] boot {boot:.2f} s ({eng.allocator.n_blocks} int8 blocks of "
        f"{eng.kv_bytes_per_block} bytes); /parse 200 in {1e3 * wall:.1f} ms")
    return {"boot_s": boot, "wall_ms": 1e3 * wall, "status": status, "launches": c.counts}


DENSE_SLOTS = 8


def phase_batch_dense(params, totals: dict, report: dict) -> None:
    """The dense batched engine (BRAIN_BATCH > 1 without BRAIN_PAGED): 8
    dense cache lines behind a ContinuousBatcher drain 8 sessions of the
    batch traffic at ff=8 (K3 at B = 8, idle rows writing slot 0 of their
    own line) and ff=0 (K2), and must decode what the paged engine (K7 /
    K6) decodes from the same prompts on the same weights. As in the radix
    phase, a parting in bf16 activations is reported with its margin and
    fails past ``BF16_PART_ULPS``; with fp32 activations on the same int8
    weights it fails past one bf16 ulp."""
    import torch

    from tpu_voice_agent_torch.serve.engine import DecodeEngine
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    torch.backends.cuda.matmul.allow_tf32 = False
    prompts = [_batch_prompt(i) for i in range(DENSE_SLOTS)]
    out = {}
    for dtype, p in (("bf16", params), ("fp32", _fp32_activations(params))):
        for ff, kernel in ((8, "decode_block_attention_layer"), (0, "decode_attention_layer")):
            label = f"batch_dense {dtype} ff={ff}"
            dense = DecodeEngine(preset="tinyllama-1.1b", quant="int8", fast_forward=ff,
                                 max_len=2048, batch_slots=DENSE_SLOTS, prefill_buckets=(1024,),
                                 init_weights=False)
            dense.load_params(p)
            install_prompt_prefix(dense)
            b = ContinuousBatcher(dense, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS)
            with Counted(label, totals) as c:
                t0 = time.perf_counter()
                res = b.generate_many(prompts)
                wall = time.perf_counter() - t0
            c.require(kernel, "masked_argmax_advance")
            fail_if(any(r.error is not None for r in res),
                    f"{label}: {[r.error for r in res if r.error][:3]}")
            fail_if(min(dense.fsm.walk(r.token_ids) for r in res) < 0,
                    f"{label}: a token stream left the grammar")
            del dense, b
            paged = _paged_engine(p, ff, radix_enable=False, batch_slots=DENSE_SLOTS)
            install_prompt_prefix(paged)
            res_p = ContinuousBatcher(paged, chunk_steps=16,
                                      max_new_tokens=BATCH_NEW_TOKENS).generate_many(prompts)
            ids = [paged.tokenizer.encode(pr, bos=True) for pr in prompts]
            diverged = _partings(paged, ids, [r.token_ids for r in res],
                                 [r.token_ids for r in res_p], label, "dense and paged")
            _check_partings(diverged, label, 1 if dtype == "fp32" else BF16_PART_ULPS)
            tokens = sum(r.steps for r in res)
            log(f"[{label}] {DENSE_SLOTS}/{DENSE_SLOTS} ok, {tokens} tokens in {wall:.3f} s "
                f"({DENSE_SLOTS / wall:.3f} intents/s); the paged engine decoded the same ids "
                f"for {DENSE_SLOTS - len(diverged)} of {DENSE_SLOTS}")
            out[f"{dtype}_ff{ff}"] = {"wall_s": wall, "tokens": tokens, "diverged": diverged,
                                      "launches": c.counts}
            del paged
        del p
    report["batch_dense"] = out


def _profile_batch_chunk(eng, report: dict, tier: str = "bf16", kind: str = "ff8") -> None:
    """The first decode chunk after 32 admissions under the profiler:
    before each call (untimed) the batcher drains and admits 32 fresh
    sessions, so the chunk starts with every row live. ``tier`` names the
    engine's KV pool and ``kind`` its decode (ff8, or spec for verify
    steps) in the label and the report key."""
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher

    b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS)

    def admit():
        b.reset()  # drop the last measurement's rows undecoded: only its first chunk counts
        for i in range(BATCH_SLOTS):
            b.submit(_batch_prompt(i))
        b._admit_pending(b._active_h)

    def chunk():
        live = int(b._active_h.sum())
        b.step()
        return f"{live} live rows at its start, {eng._last_fwds} forwards"

    key = f"batch_{kind}" if tier == "bf16" else f"kvquant_{tier}_{kind}"
    _profile(f"{kind} batch chunk (32 rows, 16 steps, {tier} KV)", chunk, key, report,
             setup=admit)
    b.run_until_done()


def phase_batch_golden(totals: dict, report: dict) -> None:
    """The distilled checkpoint (fp32) in a PagedDecodeEngine with 15 slots:
    every golden utterance submitted at once must reproduce the recorded JAX
    parse token for token, through K1 (fresh prefills), K6 and K4."""
    import torch

    from tpu_voice_agent_torch import distilled
    from tpu_voice_agent_torch.schemas import parse_response_from_json
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = distilled.golden_records()
    cfg, params = distilled.load_distilled(device="cuda")
    from dataclasses import replace

    eng = PagedDecodeEngine(cfg=replace(cfg, max_seq_len=512), max_len=512,
                            prefill_buckets=(64, 128), init_weights=False, device="cuda",
                            batch_slots=15)
    eng.load_params(params)
    b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=300)
    with Counted("batch_golden", totals) as c:
        t0 = time.perf_counter()
        res = b.generate_many([distilled.distilled_prompt(r["text"], r["context"])
                               for r in recs])
        wall = time.perf_counter() - t0
    c.require("flash_attention", "paged_attention", "masked_argmax_advance")
    bad = [(rec, r) for rec, r in zip(recs, res)
           if r.token_ids != rec["token_ids"]
           or parse_response_from_json(r.text)[0] != rec["response"]]
    for rec, r in bad:
        i = next((j for j, (x, y) in enumerate(zip(r.token_ids, rec["token_ids"])) if x != y),
                 min(len(r.token_ids), len(rec["token_ids"])))
        log(f"[batch_golden] MISMATCH {rec['text']!r} at step {i} ({r.error})")
    fail_if(bool(bad), f"batch_golden: {len(bad)} of {len(recs)} parses differ")
    fail_if(eng.allocator.blocks_in_use != 0, "batch_golden: blocks leaked")
    log(f"[batch_golden] {len(recs)} of {len(recs)} batched paged parses equal the recorded "
        f"JAX output ({sum(r.steps for r in res)} tokens, {b.chunks} chunks, {wall:.2f} s)")
    report["batch_golden"] = {"cases": len(recs), "chunks": b.chunks, "seconds": wall,
                              "launches": c.counts}


def phase_kvquant_golden(totals: dict, report: dict) -> None:
    """The distilled checkpoint (fp32) in a 15-slot PagedDecodeEngine set up
    as in batch_golden, once per KV tier: every golden utterance must equal
    the JAX package's recording for that tier token for token
    (``data/intent_golden_kvquant.json``), through K1, K8 and K4. Then
    ``kv_quant_differential`` on ``GOLDEN_INTENT_CASES[:6]`` as the JAX test
    sets it up (the few-shot prefix, cache 2048, two slots) must hold that
    test's floors (tests/test_kv_quant.py:482-507): int8 token-identical and
    type-agreeing on every case, int4 grammar-valid on every case and
    type-agreeing on at least half."""
    import torch

    from tpu_voice_agent_torch import distilled
    from tpu_voice_agent_torch.evals.golden import GOLDEN_INTENT_CASES, kv_quant_differential
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recording = distilled.kvquant_golden_records()
    cfg, params = distilled.load_distilled(device="cuda")
    from dataclasses import replace

    out = {}
    for tier in ("int8", "int4"):
        recs = recording["tiers"][tier]
        eng = PagedDecodeEngine(cfg=replace(cfg, max_seq_len=512), max_len=512,
                                prefill_buckets=(64, 128), init_weights=False, device="cuda",
                                batch_slots=15, kv_quant=tier)
        eng.load_params(params)
        b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=300)
        with Counted(f"kvquant_golden {tier}", totals) as c:
            t0 = time.perf_counter()
            res = b.generate_many([distilled.distilled_prompt(r["text"], r["context"])
                                   for r in recs])
            wall = time.perf_counter() - t0
        c.require("flash_attention", "paged_attention_quant", "masked_argmax_advance")
        fail_if(c.counts.get("paged_attention", 0) > 0, f"kvquant_golden {tier}: K6 launched")
        bad = [(rec, r) for rec, r in zip(recs, res) if r.token_ids != rec["token_ids"]]
        for rec, r in bad:
            i = next((j for j, (x, y) in enumerate(zip(r.token_ids, rec["token_ids"]))
                      if x != y), min(len(r.token_ids), len(rec["token_ids"])))
            log(f"[kvquant_golden {tier}] MISMATCH {rec['text']!r} at step {i} ({r.error})")
        fail_if(bool(bad), f"kvquant_golden {tier}: {len(bad)} of {len(recs)} parses differ")
        fail_if(eng.allocator.blocks_in_use != 0, f"kvquant_golden {tier}: blocks leaked")
        log(f"[kvquant_golden {tier}] {len(recs)} of {len(recs)} batched parses equal the JAX "
            f"recording ({sum(r.steps for r in res)} tokens, {b.chunks} chunks, {wall:.2f} s)")
        out[tier] = {"cases": len(recs), "chunks": b.chunks, "seconds": wall,
                     "launches": c.counts}
        del eng, b

    def make_engine(tier):
        eng = PagedDecodeEngine(cfg=cfg, max_len=2048, batch_slots=2,
                                prefill_buckets=(256, 512, 1024), kv_quant=tier,
                                init_weights=False, device="cuda")
        eng.load_params(params)
        install_prompt_prefix(eng)
        return eng

    with Counted("kvquant_golden differential", totals) as c:
        t0 = time.perf_counter()
        diff = kv_quant_differential(make_engine, GOLDEN_INTENT_CASES[:6])
        wall = time.perf_counter() - t0
    i8, i4 = diff["tiers"]["int8"], diff["tiers"]["int4"]
    log(f"[kvquant_golden] differential on 6 cases in {wall:.2f} s: int8 {i8}, int4 {i4}; "
        f"the JAX recording's: {recording['differential']['tiers']}")
    fail_if(not (i8["token_identical"] == i8["type_agreement"] == i8["grammar_valid"] == 1.0),
            f"kvquant_golden: int8 under its floors: {i8}")
    fail_if(not (i4["grammar_valid"] == 1.0 and i4["type_agreement"] >= 0.5),
            f"kvquant_golden: int4 under its floors: {i4}")
    out["differential"] = {**diff, "equals_jax": diff == recording["differential"],
                           "seconds": wall, "launches": c.counts}
    report["kvquant_golden"] = out


RADIX_TURNS = ["search for wireless headphones", "sort them by price", "open the second one",
               "add it to the cart"]


def _radix_sessions(params, label: str, totals: dict, kv_quant: str = "off"):
    """4 sessions x 4 turns through a radix-on BatchedEngineParser's
    transcripts (32 slots, ff=8, buckets up to 2048, 128 new tokens, the
    pool at ``kv_quant``); every turn is recorded whether or not it reached
    EOS. Returns (per-turn rows, [(prompt ids, generated ids)], tree hits,
    lookups, launch counts, seconds, prefix length)."""
    from tpu_voice_agent_torch.services.brain import BatchedEngineParser, install_prompt_prefix

    on = _paged_engine(params, 8, radix_enable=True, prefill_buckets=RADIX_BUCKETS,
                       kv_quant=kv_quant)
    P = install_prompt_prefix(on)
    parser = BatchedEngineParser(on, max_new_tokens=BATCH_NEW_TOKENS, session_aware=True)
    sids = [f"session-{i}" for i in range(4)]
    rows, prompts = [], []
    try:
        with Counted(label, totals) as c:
            t0 = time.perf_counter()
            for t, text in enumerate(RADIX_TURNS):
                futs = []
                for sid in sids:
                    prompt = parser.transcripts.prompt_for(sid, f"{text} ({sid})", {})
                    futs.append((sid, prompt, parser.loop.submit(prompt)))
                for sid, prompt, fut in futs:
                    res = fut.result(timeout=600)
                    fail_if(res.error is not None, f"{label}: {sid} turn {t + 1}: {res.error}")
                    parser.transcripts.record(sid, prompt, res.token_ids)
                    ids = (on.tokenizer.encode(prompt, bos=True) if isinstance(prompt, str)
                           else list(prompt))
                    prompts.append((ids, res.token_ids))
                    rows.append({"session": sid, "turn": t + 1,
                                 "prompt_tokens": res.prompt_tokens,
                                 "cached_tokens": res.cached_tokens,
                                 "prefill_ms": res.prefill_ms, "tokens": res.steps})
            wall = time.perf_counter() - t0
        c.require("paged_block_attention" if kv_quant == "off" else "paged_block_attention_quant",
                  "masked_argmax_advance")
    finally:
        parser.close()
    for r in rows:
        fail_if(r["turn"] >= 2 and r["cached_tokens"] <= P,
                f"{label}: {r['session']} turn {r['turn']} cached only {r['cached_tokens']} "
                f"tokens (prefix {P})")
    return rows, prompts, on.radix.hits, on.radix.lookups, c.counts, wall, P


def _partings(eng, ids_list, gen_a, gen_b, label: str, what: str) -> list[dict]:
    """For each prompt whose two token streams differ: the first differing
    step and the plain forward's top-2 margin there, under ``eng``'s
    weights."""
    diverged = []
    for ids, a, b in zip(ids_list, gen_a, gen_b):
        if a == b:
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        d = {"prompt_tokens": len(ids), "step": i,
             "picks": [a[i] if i < len(a) else None, b[i] if i < len(b) else None],
             **_plain_top2(eng, ids, b[:i])}
        diverged.append(d)
        also = "" if "bf16" not in d else (
            f"; on a bf16 cache top-2 {d['bf16']['top2']}, margin {d['bf16']['margin']:.6f} "
            f"against {d['bf16']['top_logit']:.4f} ({_ulps(d['bf16']):.2f} ulps)")
        log(f"[{label}] {what} part at step {i} of a {len(ids)}-token prompt (picks "
            f"{d['picks']}): plain top-2 {d['top2']}, margin {d['margin']:.6f} against top "
            f"logit {d['top_logit']:.4f} ({_ulps(d):.2f} bf16 ulps){also}")
    return diverged


# The widest bf16 parting read so far is 11.6 bf16 ulps (2^-8 of the top
# logit) of the plain forward's top-2 margin (radix phase, PERF.md); a
# bf16 parting past this many ulps fails. With fp32 activations the limit
# is one ulp.
BF16_PART_ULPS = 32


def _check_partings(diverged: list[dict], label: str, ulps: float) -> None:
    for d in diverged:
        fail_if(d["margin"] > ulps * 2.0 ** -8 * abs(d["top_logit"]),
                f"{label}: the streams part at step {d['step']} where the plain forward's "
                f"margin is {d['margin']:.6f} (top logit {d['top_logit']:.4f}), over {ulps} "
                f"bf16 ulps")


def _radix_off_divergence(params, prompts, label: str, kv_quant: str = "off") -> list[dict]:
    """The same prompt ids through a radix-off engine on the same weights and
    pool tier: for each turn whose ids differ, the first differing step and
    the plain forward's top-2 margin there."""
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    off = _paged_engine(params, 8, radix_enable=False, prefill_buckets=RADIX_BUCKETS,
                        kv_quant=kv_quant)
    install_prompt_prefix(off)
    res_off = ContinuousBatcher(off, chunk_steps=16,
                                max_new_tokens=BATCH_NEW_TOKENS).generate_many(
        [ids for ids, _ in prompts])
    return _partings(off, [ids for ids, _ in prompts], [gen for _, gen in prompts],
                     [r.token_ids for r in res_off], label, "radix on and off")


def _fp32_activations(params: dict) -> dict:
    """The same weights with fp32 activations: the embedding and the norms
    in fp32 (so every product and the residual stream run in fp32), the
    int8 leaves unchanged."""
    def conv(leaf):
        return leaf if isinstance(leaf, dict) else leaf.float()

    layers = params["layers"]
    layers = ({k: conv(v) for k, v in layers.items()} if isinstance(layers, dict)
              else [{k: conv(v) for k, v in layer.items()} for layer in layers])
    return {"embed": params["embed"].float(), "final_norm": params["final_norm"].float(),
            "lm_head": conv(params["lm_head"]), "layers": layers}


RADIX_BUCKETS = (128, 256, 512, 1024, 2048)


def phase_radix(params, totals: dict, report: dict) -> None:
    """Session KV reuse at full width (RADIX_ENABLE's paged engine behind a
    BatchedEngineParser, 4 sessions x 4 turns through its transcripts).
    Turns >= 2 must be served from more cache than the 879-token prefix.
    Radix on must decode what radix off decodes from the same prompt ids.
    In bf16 activations (the serving dtype) the two attend KV written by
    different kernels (decode steps against one suffix prefill), each
    rounded to bf16, and random weights leave near-ties everywhere (top-2
    margins of ~0.01 on logits of ~1), so a divergence there is reported
    with its margin and fails past ``BF16_PART_ULPS``. The identity is held
    with fp32 activations on the same int8 weights: there a divergence fails
    unless the plain forward's margin is below one bf16 ulp of the top
    logit (2^-8 of it)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for dtype, p in (("bf16", params), ("fp32", _fp32_activations(params))):
        label = f"radix {dtype}"
        rows, prompts, hits, lookups, counts, wall, P = _radix_sessions(p, label, totals)
        diverged = _radix_off_divergence(p, prompts, label)
        _check_partings(diverged, label, 1 if dtype == "fp32" else BF16_PART_ULPS)
        cached = [r["cached_tokens"] for r in rows]
        log(f"[{label}] 4 sessions x 4 turns in {wall:.2f} s: cached tokens per turn {cached} "
            f"(prefix {P}); tree hits {hits} of {lookups} lookups; radix off decoded the same "
            f"ids for {len(prompts) - len(diverged)} of {len(prompts)} turns")
        out[dtype] = {"prefix_tokens": P, "turns": rows, "seconds": wall, "hits": hits,
                      "lookups": lookups, "diverged": diverged, "launches": counts}
        del p
    report["radix"] = out


def phase_service_batched(totals: dict, report: dict) -> None:
    """A second in-process brain: BRAIN_BATCH=8 BRAIN_PAGED=1
    RADIX_ENABLE=1 at tinyllama-1.1b int8, answering 8 concurrent /parse
    requests (random weights: 422 truncation, or a valid 200)."""
    from tpu_voice_agent_torch.schemas import validate_parse_response
    from tpu_voice_agent_torch.services import brain

    os.environ.update(BRAIN_BACKEND="engine:tinyllama-1.1b", BRAIN_QUANT="int8",
                      BRAIN_BATCH="8", BRAIN_PAGED="1", RADIX_ENABLE="1")
    for k in ("BRAIN_FF", "BRAIN_PREFIX", "BRAIN_DEVICE", "BRAIN_POOL_BLOCKS", "BRAIN_CHUNK",
              "KV_QUANT"):
        os.environ.pop(k, None)
    try:
        t0 = time.perf_counter()
        parser = brain.make_parser_from_env()
    finally:
        for k in ("BRAIN_BATCH", "BRAIN_PAGED", "RADIX_ENABLE"):
            os.environ.pop(k, None)
    eng = parser.engine
    fail_if(not (isinstance(parser, brain.BatchedEngineParser) and parser.wants_session
                 and eng.batch_slots == 8 and eng.radix is not None
                 and eng.device.type == "cuda"),
            "service_batched: not a session-aware batched paged parser on the card")
    log(f"[service_batched] boot {time.perf_counter() - t0:.2f} s: 8 slots, pool "
        f"{eng.allocator.n_blocks} blocks, prefix {len(eng.prefix_ids)} tokens")
    server, thread, base = _serve_brain(brain.BrainApp(parser))
    results = [None] * 8

    def one(i):
        t1 = time.perf_counter()
        text = UTTERANCES[i % len(UTTERANCES)]
        results[i] = (*_post(base, {"text": text, "session_id": f"s{i}", "context": {}}),
                      (time.perf_counter() - t1) * 1e3)

    try:
        with Counted("service_batched", totals) as c:
            t0 = time.perf_counter()
            workers = [threading.Thread(target=one, args=(i,)) for i in range(8)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=900)
            wall = time.perf_counter() - t0
    finally:
        _stop(server, thread)
        parser.close()
    c.require("paged_block_attention", "masked_argmax_advance")
    for i, r in enumerate(results):
        fail_if(r is None, f"service_batched: request {i} got no answer")
        status, body, _ms = r
        truncated = (status == 422 and body.get("detail", "").startswith("decode truncated"))
        complete = status == 200 and validate_parse_response(body) == (body, None)
        fail_if(not (truncated or complete), f"service_batched: request {i}: {status} {body}")
    walls = [r[2] for r in results]
    log(f"[service_batched] 8 concurrent /parse answered in {wall:.2f} s (each "
        f"{min(walls):.0f}-{max(walls):.0f} ms): statuses {[r[0] for r in results]}; "
        f"{parser.batcher.chunks} chunks")
    report["service_batched"] = {"seconds": wall, "walls_ms": walls,
                                 "statuses": [r[0] for r in results],
                                 "chunks": parser.batcher.chunks, "launches": c.counts}


# ------------------------------------------------------------------ quality lanes

# one recorded batch of lanes (fp32 on the card) against an fp64
# recomputation on the CPU over the same logits: an fp32 top-2 gap and
# entropy sit a few ulp from the exact values
QUALITY_FP64_TOL = 1e-4
# the trained stack on the card against the same stack on the CPU (fp32,
# tf32 off on the card): each confidence lane and x-intent-margin within
QUALITY_CPU_TOL = 1e-3


def _set_lanes(eng, on: bool) -> None:
    """The quality lanes of one engine object, on or off (its spec decoder's
    too)."""
    eng.quality_lanes = on
    if getattr(eng, "spec", None) is not None:
        eng.spec.quality_lanes = on


def _record_conf(modules):
    """Wrap each module's ``_conf_stats`` so that the first call's inputs
    and outputs are kept. Returns (record, restore)."""
    rec: dict = {}
    saved = [(m, m._conf_stats) for m in modules]

    def wrap(real):
        def recording(raw, state, tables, constrained, *rest):
            out = real(raw, state, tables, constrained, *rest)
            if not rec:
                rec.update(raw=raw.detach().clone(), state=state.clone(), tables=tables,
                           out=[o.clone() for o in out])
            return out
        return recording

    for m, real in saved:
        m._conf_stats = wrap(real)

    def restore():
        for m, real in saved:
            m._conf_stats = real

    return rec, restore


def _conf_fp64_err(rec: dict) -> dict:
    """The recorded lanes against ``_masked_conf`` in fp64 on the CPU, over
    the same logits and the same legal rows."""
    import torch

    from tpu_voice_agent_torch.grammar.fsm import fsm_row
    from tpu_voice_agent_torch.serve.engine import _masked_conf

    state = rec["state"]
    legal = ((fsm_row(rec["tables"], torch.clamp(state, min=0)) >= 0)
             & (state >= 0)[:, None]).cpu()
    m, e, f = _masked_conf(torch.where(legal, rec["raw"].double().cpu(), float("-inf")),
                           legal.sum(-1))
    mc, ec, fc = (o.cpu() for o in rec["out"])
    return {"rows": int(state.numel()), "margin_err": float((mc.double() - m).abs().max()),
            "entropy_err": float((ec.double() - e).abs().max()),
            "forced_equal": bool(torch.equal(fc, f)), "forced_rows": int(fc.sum())}


def _device_kernels(fn) -> int:
    """Device kernels one call of ``fn`` launches (torch.profiler, CUDA
    activity only: the host ops' trace adds nothing to the count and cost
    ~10-25 s a call); 0 when the profiler sees no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type != DeviceType.CPU)


def _chunk_lanes(eng, label: str) -> dict:
    """One batch chunk after 32 admissions, lanes on and off on the same
    engine: its wall (one each, unprofiled, the two modes in turns) and
    the device kernels a 4-step chunk launches (profiled after its
    admissions; a short chunk keeps the profiler's trace small)."""
    import torch

    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher

    b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS)

    def admit():
        b.reset()  # drop the last measurement's rows undecoded: only its first chunk counts
        for i in range(BATCH_SLOTS):
            b.submit(_batch_prompt(i))
        b._admit_pending(b._active_h)
        torch.cuda.synchronize()

    # the walls in turns (on, off), one each: a depth the script's time
    # limit sets
    walls = {True: [], False: []}
    for lanes in (True, False):
        _set_lanes(eng, lanes)
        admit()
        t0 = time.perf_counter()
        b.step()
        torch.cuda.synchronize()
        walls[lanes].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for lanes in (True, False):
        _set_lanes(eng, lanes)
        admit()
        b.chunk_steps = 4
        try:
            n = _device_kernels(b.step)
        finally:
            b.chunk_steps = 16
        fwds = int(eng._last_fwds)
        out["on" if lanes else "off"] = {
            "chunk_ms_p50": statistics.median(walls[lanes]), "chunk_walls_ms": walls[lanes],
            "profiled_kernels": n, "profiled_forwards": fwds,
            "kernels_per_forward": n / fwds if n and fwds else None}
    _set_lanes(eng, True)
    b.reset()
    on, off = out["on"], out["off"]
    added = ((on["profiled_kernels"] - off["profiled_kernels"]) / on["profiled_forwards"]
             if on["kernels_per_forward"] and off["kernels_per_forward"]
             and on["profiled_forwards"] == off["profiled_forwards"] else None)
    out["kernels_added_per_forward"] = added
    log(f"[{label}] chunk (32 rows, 16 steps) wall p50 lanes on {on['chunk_ms_p50']:.2f} ms, "
        f"off {off['chunk_ms_p50']:.2f} ms; a 4-step chunk launches {on['profiled_kernels']} "
        f"kernels in {on['profiled_forwards']} forwards lanes on, {off['profiled_kernels']} in "
        f"{off['profiled_forwards']} off: {added} added per forward")
    return out


def phase_quality(params, totals: dict, report: dict) -> None:
    """The quality lanes at full width (tinyllama-1.1b int8, random weights):
    the batch phase's 32 sessions through the paged batched engine at ff 8
    (K7) and through the paged spec engine (K7, K11), each drained with the
    lanes on and then off on the same engine object: equal tokens,
    ``quality`` on every result with the lanes on and None with them off;
    the first recorded batch of lanes against an fp64 recomputation on the
    CPU; one chunk's wall and device kernels per forward, lanes on and off."""
    from tpu_voice_agent_torch.serve import engine as engine_mod
    from tpu_voice_agent_torch.serve import spec as spec_mod
    from tpu_voice_agent_torch.serve.spec import SpecConfig

    out = {}
    for kind, ff, kw, kernels in (
            ("ff8", 8, {}, ("paged_block_attention", "masked_argmax_advance")),
            ("spec", 0, {"spec": SpecConfig(k=SPEC_K)}, ("paged_block_attention",
                                                         "masked_argmax"))):
        label = f"quality {kind}"
        eng = _paged_engine(params, ff, radix_enable=False, **kw)
        fail_if(not eng.quality_lanes, f"{label}: QUALITY_ENABLE unset must turn the lanes on")
        rec, restore = _record_conf([engine_mod, spec_mod])
        try:
            row_on, res_on, c = _drain(eng, f"{label} lanes on", totals)
        finally:
            restore()
        c.require(*kernels)
        _set_lanes(eng, False)
        row_off, res_off, _c = _drain(eng, f"{label} lanes off", totals)
        _set_lanes(eng, True)
        fail_if([r.token_ids for r in res_on] != [r.token_ids for r in res_off],
                f"{label}: the lanes changed a token")
        fail_if(any(r.quality is None for r in res_on), f"{label}: a result without quality")
        fail_if(any(r.quality is not None for r in res_off),
                f"{label}: quality with the lanes off")
        err = _conf_fp64_err(rec)
        log(f"[{label}] one recorded batch ({err['rows']} rows, {err['forced_rows']} forced) "
            f"against fp64: margin {err['margin_err']:.3g}, entropy {err['entropy_err']:.3g} "
            f"(tolerance {QUALITY_FP64_TOL:g}), forced flags equal {err['forced_equal']}")
        fail_if(err["margin_err"] > QUALITY_FP64_TOL or err["entropy_err"] > QUALITY_FP64_TOL
                or not err["forced_equal"], f"{label}: the card's lanes disagree with fp64")
        means = {k: statistics.mean(r.quality[k] for r in res_on)
                 for k in ("margin_mean", "entropy_mean", "forced_frac")}
        out[kind] = {"lanes_on": row_on, "lanes_off": row_off, "fp64": err,
                     "quality_means": means, "chunk": _chunk_lanes(eng, label)}
        log(f"[{label}] drain lanes on {row_on['wall_s']:.3f} s, off {row_off['wall_s']:.3f} s; "
            f"mean over sessions: {json.dumps({k: round(v, 4) for k, v in means.items()})}")
        del eng
    report["quality"] = out


# ---------------------------------------------------------------- containment

# the drill: the 3rd admission's logits turn NaN, the 7th's FSM state dead,
# the 11th prefill_slot call raises, the 5th block allocation fails (its
# request is requeued and admitted later, so it decodes its clean tokens)
CONTAINMENT_SPEC = "nan_logits@3,dead_fsm@7,prefill_exc@11,alloc_fail@5"
CONTAINMENT_ERRORS = sorted(["poisoned: non-finite logits", "poisoned: grammar dead state",
                             "chaos: injected prefill exception"])
TTFT_SHORT = 8  # short requests queued behind one long prompt
_KEPT: dict = {}  # the batch phase's engines, reused by the containment phase


def _k4_poison_rows(eng) -> dict:
    """K4 on the card on a (32, V) batch that mixes healthy, NaN and dead
    (-1 state) rows, against its plain version on the same inputs: healthy
    and dead rows (a dead state is clamped to 0 on both sides) must pick
    the same token and state; a NaN row must pick a token in range and a
    state of its table row (no read out of bounds). The poison gate must
    then keep exactly the healthy rows whose pick is live."""
    import torch

    from tpu_voice_agent_torch.ops.grammar_mask import (
        masked_argmax_advance,
        masked_argmax_advance_reference,
    )
    from tpu_voice_agent_torch.serve.engine import _poison_gate

    t = eng.tables
    B, V = BATCH_SLOTS, t.dense_mask.shape[1]
    g = torch.Generator(device="cuda").manual_seed(15)
    logits = torch.randn((B, V), generator=g, device="cuda")
    state = torch.randint(0, t.table.shape[0], (B,), generator=g, device="cuda",
                          dtype=torch.int32)
    rows = torch.arange(B, device="cuda")
    nan_rows, dead_rows = rows % 4 == 1, rows % 4 == 2
    logits[nan_rows] = float("nan")
    state = torch.where(dead_rows, -1, state).to(torch.int32)
    tok, nxt = masked_argmax_advance(logits, state, t.dense_mask, t.table, t.col_id)
    rtok, rnxt = masked_argmax_advance_reference(logits, state, t.dense_mask, t.table, t.col_id)
    torch.cuda.synchronize()
    keep = ~nan_rows
    fail_if(not torch.equal(tok[keep], rtok[keep]) or not torch.equal(nxt[keep], rnxt[keep]),
            "containment: K4 disagrees with its plain version on a healthy or dead row")
    row_of = t.table[torch.clamp(state, min=0).long()]
    in_row = (row_of == nxt[:, None]).any(dim=1)
    fail_if(not bool(((tok >= 0) & (tok < V))[nan_rows].all())
            or not bool(in_row[nan_rows].all()),
            "containment: K4 on a NaN row left the token range or its table row")
    ok, poison = _poison_gate(logits, state, nxt, torch.ones(B, dtype=torch.bool, device="cuda"),
                              torch.zeros(B, dtype=torch.int32, device="cuda"), True)
    want = ~nan_rows & ~dead_rows & (rnxt >= 0)
    fail_if(not torch.equal(ok, want) or not bool((poison[nan_rows] == 1).all())
            or not bool((poison[dead_rows] == 2).all()),
            "containment: the poison gate kept a NaN or dead row")
    out = {"rows": B, "nan_rows": int(nan_rows.sum()), "dead_rows": int(dead_rows.sum()),
           "healthy_equal": True, "kept": int(ok.sum())}
    log(f"[containment] K4 on {B} rows ({out['nan_rows']} NaN, {out['dead_rows']} dead): "
        f"healthy and dead rows equal to the plain version, NaN rows in range, the gate "
        f"keeps {out['kept']}")
    return out


def _run32(eng, prompts=None, batcher_cls=None, **kw):
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher

    if not eng.prefix_ids:
        _install(eng)
    cls = batcher_cls or ContinuousBatcher
    b = cls(eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS, **kw)
    return b, b.generate_many(prompts or [_batch_prompt(i) for i in range(BATCH_SLOTS)])


def _drill(eng, label: str, totals: dict, kernels) -> tuple[dict, list]:
    """The batch phase's 32 requests clean, then under ``CONTAINMENT_SPEC``:
    exactly the three drilled requests fail with JAX's typed errors and
    every other one decodes its clean tokens; then one prompt poisoned
    ``QUARANTINE_AFTER`` times is refused at submit and the flight recorder
    froze with ``scheduler.quarantine`` and a step ledger; the pool ends at
    its starting free blocks."""
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.utils import chaos
    from tpu_voice_agent_torch.utils.tracing import get_flight_recorder

    P = len(eng.prefix_ids) or _install(eng)
    free0 = eng.allocator.free_blocks()
    with Counted(label, totals) as c:
        _b, clean = _run32(eng)
        chaos.configure(CONTAINMENT_SPEC, seed=0)
        try:
            _b, drilled = _run32(eng)
        finally:
            chaos.reset()
    c.require(*kernels)
    fail_if(any(r.error for r in clean), f"{label}: the clean run failed")
    errs = sorted(r.error for r in drilled if r.error)
    same = sum(r.error is None and r.token_ids == k.token_ids for r, k in zip(drilled, clean))
    log(f"[{label}] drill {CONTAINMENT_SPEC}: errors {errs}; {same}/{BATCH_SLOTS - 3} "
        "batch-mates equal to the clean run")
    fail_if(errs != CONTAINMENT_ERRORS, f"{label}: drilled errors {errs}")
    fail_if(same != BATCH_SLOTS - 3, f"{label}: a batch-mate's tokens moved under the drill")
    rec = get_flight_recorder()
    rec.rearm()
    with Counted(f"{label} quarantine", totals):
        qb = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS)
        for _ in range(qb.quarantine_after):
            chaos.configure("nan_logits:1")
            try:
                r = qb.generate_many([_batch_prompt(0)])[0]
            finally:
                chaos.reset()
            fail_if(r.error != "poisoned: non-finite logits", f"{label}: poison {r.error}")
        rid = qb.submit(_batch_prompt(0))
        refused = qb.results.pop(rid, None)
    fail_if(refused is None or not (refused.error or "").startswith("quarantined:"),
            f"{label}: a prompt poisoned {qb.quarantine_after} times was not refused at submit")
    dump = rec.frozen_dump()
    fail_if(dump is None or dump["reason"] != "scheduler.quarantine"
            or not dump["steplog"]["steps"],
            f"{label}: the flight recorder did not freeze with the step ledger")
    rec.rearm()
    fail_if(eng.allocator.free_blocks() != free0,
            f"{label}: {free0 - eng.allocator.free_blocks()} blocks leaked")
    log(f"[{label}] quarantine after {qb.quarantine_after}: {refused.error[:60]}...; flight "
        f"recorder froze on {dump['reason']} with {len(dump['steplog']['steps'])} steps; "
        f"{eng.allocator.free_blocks()} blocks free, as before (prefix {P} tokens)")
    return {"errors": errs, "batch_mates_equal": same, "quarantined": refused.error,
            "flight_reason": dump["reason"], "free_blocks": free0, "launches": c.counts}, clean


def _install(eng) -> int:
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    return install_prompt_prefix(eng)


def _deadline_and_cancel(eng, clean, totals: dict) -> dict:
    """Behind a full batch: a request with a 1 ms budget sheds at dequeue,
    and a request abandoned after its first chunk is evicted at once; the
    30 others decode their clean tokens."""
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.resilience import Deadline

    free0 = eng.allocator.free_blocks()
    b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS)
    with Counted("containment deadlines", totals):
        rids = [b.submit(_batch_prompt(i)) for i in range(BATCH_SLOTS)]
        late = b.submit(_batch_prompt(BATCH_SLOTS), deadline=Deadline.after(0.001))
        b.step()
        fail_if(late in b.results, "containment: the late request was served before a slot freed")
        b.cancel(rids[5], "client gone")
        evicted = b.results.get(rids[5])
        b.run_until_done()
    res = [b.results.pop(r) for r in rids]
    shed = b.results.pop(late)
    fail_if(evicted is None or evicted.error != "cancelled: client gone",
            f"containment: the abandoned request was not evicted at once: {evicted}")
    fail_if(shed.error != "shed: deadline expired in queue", f"containment: late {shed.error}")
    same = sum(r.token_ids == k.token_ids for i, (r, k) in enumerate(zip(res, clean)) if i != 5)
    fail_if(same != BATCH_SLOTS - 1, "containment: a batch-mate moved under the cancel")
    fail_if(eng.allocator.free_blocks() != free0, "containment: blocks leaked")
    log(f"[containment] deadline: '{shed.error}'; cancel after one chunk: '{evicted.error}' at "
        f"once; {same}/{BATCH_SLOTS - 1} batch-mates equal")
    return {"shed": shed.error, "cancelled": evicted.error, "batch_mates_equal": same}


def _chunked(eng, clean, label: str, totals: dict, chunks=(16, 256),
             ulps: float = BF16_PART_ULPS) -> dict:
    """The 32 requests admitted in ``PREFILL_CHUNK_TOKENS`` pieces: each
    decodes the barrier admission's tokens, or parts from them only at a
    near tie (``ulps`` bf16 ulps of the plain forward's top-2 margin): a
    piece's products (16 or 256 rows, K7 / K9 at 16) round unlike the
    barrier suffix's (its 32-row bucket, the plain attention). In bf16
    activations the limit is ``BF16_PART_ULPS``; the fp32-activation twin
    holds it at one ulp."""
    ids = [eng.tokenizer.encode(_batch_prompt(i), bos=True) for i in range(BATCH_SLOTS)]
    out = {}
    try:
        for C in chunks:
            os.environ["PREFILL_CHUNK_TOKENS"] = str(C)
            with Counted(f"{label} chunk {C}", totals):
                b, res = _run32(eng)
            fail_if(b._admitting or any(r.error for r in res), f"{label}: chunk {C} failed")
            diverged = _partings(eng, ids, [r.token_ids for r in clean],
                                 [r.token_ids for r in res], label, f"chunk {C} and barrier")
            _check_partings(diverged, f"{label} chunk {C}", ulps)
            out[C] = {"equal": BATCH_SLOTS - len(diverged),
                      "partings_ulps": [round(_ulps(d), 3) for d in diverged]}
            log(f"[{label}] chunked prefill at {C}: {out[C]['equal']}/{BATCH_SLOTS} equal to "
                f"the barrier admission, partings at {out[C]['partings_ulps']} bf16 ulps")
    finally:
        os.environ.pop("PREFILL_CHUNK_TOKENS", None)
    return out


def _chunked_fp32(params, totals: dict) -> dict:
    """Chunked prefill's identity with fp32 activations on the same int8
    weights (TF32 off), as the radix and batch_dense phases hold theirs: at
    16 (K7) and 256 the chunked admission parts from the barrier admission
    only where the plain forward's top-2 margin is below one bf16 ulp."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    eng = _paged_engine(_fp32_activations(params), 8, radix_enable=False)
    _b, clean = _run32(eng)
    fail_if(any(r.error for r in clean), "containment fp32: a barrier admission failed")
    return _chunked(eng, clean, "containment fp32", totals, ulps=1)


def _ttft_behind_long(eng, totals: dict) -> dict:
    """A reading, not a gate: one ~1000-token prompt that misses the cached
    prefix, then 8 short ones; each request's time from submit to its first
    token (synced), with chunking off and at 256 and 16."""
    import torch

    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher

    class Timed(ContinuousBatcher):
        def _finish_admission(self, slot, rid, n, last_logits, t0, t_enq):
            super()._finish_admission(slot, rid, n, last_logits, t0, t_enq)
            torch.cuda.synchronize()
            self.ttft[rid] = (time.perf_counter() - t_enq) * 1e3

    long_ids = eng.tokenizer.encode(" ".join(UTTERANCES * 40), bos=True)[:1000]
    out = {}
    try:
        for C in (None, 256, 16):
            if C is None:
                os.environ.pop("PREFILL_CHUNK_TOKENS", None)
            else:
                os.environ["PREFILL_CHUNK_TOKENS"] = str(C)
            b = Timed(eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS)
            b.ttft = {}
            with Counted(f"containment ttft chunk {C or 'off'}", totals) as c:
                torch.cuda.synchronize()
                long_rid = b.submit(long_ids)
                short = [b.submit(_batch_prompt(i)) for i in range(1, TTFT_SHORT + 1)]
                b.run_until_done()
            ms = sorted(b.ttft[r] for r in short)
            out[C or "off"] = {"short_p50_ms": _p(ms, 0.5), "short_p95_ms": _p(ms, 0.95),
                               "long_ms": b.ttft[long_rid], "launches": c.counts}
            if C is None or C == 16:
                c.require("flash_attention")  # the long prompt's fresh first block
            log(f"[containment] TTFT behind a {len(long_ids)}-token prompt, chunk "
                f"{C or 'off'}: {TTFT_SHORT} short p50 {out[C or 'off']['short_p50_ms']:.2f} / "
                f"p95 {out[C or 'off']['short_p95_ms']:.2f} ms, the long one "
                f"{b.ttft[long_rid]:.2f} ms")
    finally:
        os.environ.pop("PREFILL_CHUNK_TOKENS", None)
    return out


def _stage_split(eng, label: str, totals: dict, drains: int = 1) -> dict:
    """``drains`` clean 32-request drains with the step ledger on: every
    step's stages must tile its wall within 5%. The median per-stage ms of
    the full-batch steps, apart for the steps that admitted (their prefill
    carved out of admit) and the decode-only chunks (a stage a step did not
    have counts 0)."""
    from tpu_voice_agent_torch.utils.steplog import get_steplog

    log_ = get_steplog()
    log_.clear()
    with Counted(f"{label} steplog", totals):
        for _ in range(drains):
            _run32(eng)
    steps = log_.steps()
    for s in steps:
        acct = sum(s["stages"].values())
        fail_if(not 0.95 * s["wall_ms"] <= acct <= 1.05 * s["wall_ms"] + 1e-3,
                f"{label}: stages {s['stages']} do not tile the step's {s['wall_ms']} ms")
    live = [s for s in steps if s.get("occupancy")]
    out = {"steps": len(steps)}
    for kind, group in (("admitting", [s for s in live if s.get("admitted")]),
                        ("decode_only", [s for s in live if not s.get("admitted")])):
        fail_if(not group, f"{label}: no {kind} step in the ledger")
        med = {k: statistics.median(s["stages"].get(k, 0.0) for s in group)
               for k in ("admit", "prefill", "decode", "readback", "release", "draft")}
        wall = statistics.median(s["wall_ms"] for s in group)
        occ = statistics.median(s["occupancy"] for s in group)
        out[kind] = {"n": len(group), "median_occupancy": occ, "median_wall_ms": wall,
                     "median_stage_ms": med}
        log(f"[{label}] step ledger, {len(group)} {kind} steps (median occupancy {occ}): "
            f"median wall {wall:.3f} ms = " + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
    return out


def _host_costs() -> dict:
    """What the containment plane costs the host with chaos off: one
    ``chaos_fire`` (a dict miss and a bool test) and one step ledger entry
    (its laps, carves and record), each timed over many calls."""
    from tpu_voice_agent_torch.utils import chaos
    from tpu_voice_agent_torch.utils.steplog import StepLog

    os.environ.pop("CHAOS_FAULTS", None)
    chaos.reset()
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        chaos.chaos_fire("nan_logits")
    fire_ns = (time.perf_counter() - t0) / n * 1e9
    log_, m = StepLog(max_steps=256, enabled=True), 5_000
    t0 = time.perf_counter()
    for _ in range(m):
        t = log_.timer()
        t.lap("admit")
        t.carve("admit", "prefill", 0.5)
        t.lap("decode")
        t.lap("readback")
        t.lap("release")
        t.carve("decode", "draft", 0.0)
        t.finish(occupancy=BATCH_SLOTS, tokens=100, admitted=None, forwards=16, accepted=None)
    step_us = (time.perf_counter() - t0) / m * 1e6
    log(f"[containment] host cost with chaos off: chaos_fire {fire_ns:.1f} ns a call; one "
        f"step ledger entry {step_us:.2f} us")
    return {"chaos_fire_ns": fire_ns, "steplog_entry_us": step_us}


def _containment_service(eng, totals: dict) -> dict:
    """The brain over HTTP on the bf16 engine behind a BatchedEngineParser:
    ``/debug/steplog`` and ``/debug/flightrecorder`` answer 200; with
    ``max_inflight`` 2, 4 concurrent parses see 503 + Retry-After counted in
    ``resilience.brain.shed_overload``; a client that closes its socket
    mid-parse has its decode cancelled (``scheduler.cancelled``)."""
    import socket

    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    def counter(name):
        return get_metrics().snapshot()["counters"].get(name, 0.0)

    parser = brain.BatchedEngineParser(eng, chunk_steps=16)
    app = brain.BrainApp(parser, max_inflight=2)
    srv, th, url = _serve_brain(app)
    out = {}
    try:
        with Counted("containment service", totals) as c:
            shed0 = counter("resilience.brain.shed_overload")
            got = []

            def post(i):
                hdr = {}
                got.append((*_post(url, {"text": UTTERANCES[i], "context": {}}, hdr),
                            hdr.get("Retry-After")))

            ths = [threading.Thread(target=post, args=(i,)) for i in range(4)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(600)
            shed = [g for g in got if g[0] == 503]
            fail_if(not shed or any(g[1].get("detail") != "overload" or g[2] != "1"
                                    for g in shed),
                    f"containment: 4 parses at max_inflight 2 answered {[g[0] for g in got]}")
            fail_if(counter("resilience.brain.shed_overload") - shed0 != len(shed),
                    "containment: resilience.brain.shed_overload did not count the sheds")
            for path in ("/debug/steplog?last=4", "/debug/flightrecorder"):
                with urllib.request.urlopen(url + path, timeout=30) as r:
                    body = json.loads(r.read())
                fail_if(r.status != 200 or body.get("service") != "brain",
                        f"containment: {path} answered {r.status}")
                out[path.split("?")[0]] = sorted(body)
            fail_if(not body.get("armed") and not body.get("frozen"),
                    "containment: /debug/flightrecorder has no state")
            cancelled0 = counter("scheduler.cancelled")
            data = json.dumps({"text": UTTERANCES[0], "context": {}}).encode()
            sock = socket.create_connection(("127.0.0.1", srv.server_address[1]))
            sock.sendall(b"POST /parse HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                         b"Content-Length: " + str(len(data)).encode() + b"\r\n\r\n" + data)
            end = time.monotonic() + 60
            while not any(s.request_id >= 0 for s in parser.batcher.slots):
                fail_if(time.monotonic() > end, "containment: the raw parse never admitted")
                time.sleep(0.001)
            sock.close()
            end = time.monotonic() + 60
            while counter("scheduler.cancelled") < cancelled0 + 1:
                fail_if(time.monotonic() > end,
                        "containment: a closed client socket did not cancel its decode")
                time.sleep(0.01)
        c.require("paged_block_attention", "masked_argmax_advance")
        out.update(statuses=sorted(g[0] for g in got), sheds=len(shed), disconnect="cancelled")
        log(f"[containment] service: 4 parses at max_inflight 2 -> {out['statuses']} "
            f"(Retry-After 1), /debug/steplog and /debug/flightrecorder 200, a closed socket "
            "cancelled its decode")
    finally:
        _stop(srv, th)
        parser.close()
        app.close()
    return out


def phase_containment(params, totals: dict, report: dict) -> None:
    """Fault containment and incident capture on tinyllama-1.1b int8, paged
    and batched, 32 slots: the drills on the bf16 pool (K7), the int8 pool
    (K9) and the spec engine (K7, K11); K4 on NaN and dead rows; deadlines
    and mid-decode cancel; chunked prefill at 16 and 256 against the barrier
    admission; TTFT behind a long prompt; the step ledger's split of the
    ff 8 and ff 0 chunks; the brain's admission cap, debug routes and
    disconnect cancel over HTTP."""
    from tpu_voice_agent_torch.serve.spec import SpecConfig

    out = {}
    eng = _KEPT.pop("ff8", None) or _paged_engine(params, 8, radix_enable=False)
    eng0 = _KEPT.pop("ff0", None) or _paged_engine(params, 0, radix_enable=False)
    out["host_costs"] = _host_costs()
    out["k4_poison_rows"] = _k4_poison_rows(eng)
    out["bf16"], clean = _drill(eng, "containment bf16", totals,
                                ("paged_block_attention", "masked_argmax_advance"))
    out["deadlines"] = _deadline_and_cancel(eng, clean, totals)
    out["chunked_bf16"] = _chunked(eng, clean, "containment bf16", totals)
    out["chunked_fp32"] = _chunked_fp32(params, totals)
    out["ttft"] = _ttft_behind_long(eng, totals)
    out["steps_ff8"] = _stage_split(eng, "containment ff=8", totals)
    out["steps_ff0"] = _stage_split(eng0, "containment ff=0", totals)
    out["service"] = _containment_service(eng, totals)
    del eng, eng0
    eng8 = _paged_engine(params, 8, radix_enable=False, kv_quant="int8")
    out["int8"], clean8 = _drill(eng8, "containment int8", totals,
                                 ("paged_block_attention_quant", "masked_argmax_advance"))
    out["chunked_int8"] = _chunked(eng8, clean8, "containment int8", totals, chunks=(16,))
    del eng8
    engs = _paged_engine(params, 0, radix_enable=False, spec=SpecConfig(k=SPEC_K))
    out["spec"], _ = _drill(engs, "containment spec", totals,
                            ("paged_block_attention", "masked_argmax"))
    del engs
    report["containment"] = out


def _stt_lanes(eng) -> dict:
    """The STT lanes on one whisper-large-v3 transcribe (the 300-frame
    bucket): the same tokens with the lanes off, the lanes against an fp64
    log-softmax of the recorded step logits, and the transcribe's wall
    (median of 2, the two modes in turns), and the device kernels an
    8-token transcribe launches, lanes on and off."""
    import torch

    from tpu_voice_agent_torch.serve import stt as stt_mod
    from tpu_voice_agent_torch.voicebench import synth_utterance

    audio = synth_utterance(2.9)
    steps = []
    real = stt_mod.decoder_forward

    def recording(*a, **kw):
        lg, cache = real(*a, **kw)
        steps.append(lg[0, -1].detach().clone())
        return lg, cache

    stt_mod.decoder_forward = recording
    try:
        on = eng.transcribe(audio)
    finally:
        stt_mod.decoder_forward = real
    ids = on.token_ids
    lp = [float(torch.log_softmax(steps[i].double(), -1)[t]) for i, t in enumerate(ids)]
    fail_if([int(torch.argmax(s)) for s in steps[:len(ids)]] != ids,
            "stt lanes: the recorded logits do not pick the emitted tokens")
    ref = {"logp_mean": sum(lp) / len(lp), "logp_min": min(lp), "logp_first": lp[0]}
    err = max(abs(getattr(on, k) - v) for k, v in ref.items())
    out = {"tokens": len(ids), "fp64_err": err, "lanes": {k: getattr(on, k) for k in (
        "logp_mean", "logp_min", "logp_first", "repetition")}}
    # rounded to 4 decimals on the way out: half a step of that on top
    fail_if(err > QUALITY_FP64_TOL + 5e-5, f"stt lanes: {out['lanes']} against fp64 {ref}")
    runs = {True: [], False: []}
    for lanes in (True, False, False, True):  # in turns
        eng.quality_lanes = lanes
        t0 = time.perf_counter()
        r = eng.transcribe(audio)
        runs[lanes].append((r, (time.perf_counter() - t0) * 1e3))
    def profiled() -> tuple[int, int]:
        """Kernels and forwards of one 8-token transcribe (a short one keeps
        the profiler's trace small)."""
        budget, eng.max_new_tokens = eng.max_new_tokens, 8
        try:
            got = []
            n = _device_kernels(lambda: got.append(eng.transcribe(audio)))
        finally:
            eng.max_new_tokens = budget
        return n, got[0].forwards

    for lanes in (True, False):
        eng.quality_lanes = lanes
        rs, walls = [r for r, _ in runs[lanes]], [w for _, w in runs[lanes]]
        n, fwds = profiled()
        fail_if(any(r.token_ids != ids for r in rs), "stt lanes: the lanes changed a token")
        fail_if(any((r.logp_mean is None) == lanes for r in rs),
                f"stt lanes: logp_mean {rs[0].logp_mean} with the lanes "
                f"{'on' if lanes else 'off'}")
        out["on" if lanes else "off"] = {
            "transcribe_ms_p50": statistics.median(walls), "walls_ms": walls,
            "forwards": rs[0].forwards, "profiled_kernels": n, "profiled_forwards": fwds}
    eng.quality_lanes = True
    on_, off_ = out["on"], out["off"]
    added = ((on_["profiled_kernels"] - off_["profiled_kernels"]) / on_["profiled_forwards"]
             if on_["profiled_kernels"] and off_["profiled_kernels"] else None)
    out["kernels_added_per_forward"] = added
    log(f"[stt] lanes: {out['lanes']} ({len(ids)} tokens), fp64 error {err:.3g}; transcribe "
        f"({on_['forwards']} forwards) p50 lanes on {on_['transcribe_ms_p50']:.2f} ms, off "
        f"{off_['transcribe_ms_p50']:.2f} ms; an 8-token transcribe launches "
        f"{on_['profiled_kernels']} kernels in {on_['profiled_forwards']} decoder forwards "
        f"lanes on, {off_['profiled_kernels']} off: {added} added per forward")
    return out


# ------------------------------------------------------------------ speculation

SPEC_K = 4  # the JAX default draft width: verify blocks of 1 + 4


def _count_inside(spec) -> dict:
    """Launch counts taken inside ``spec.decode_chunk`` only (the verify
    steps and their drafting), apart from admissions: the returned dict
    fills as the decoder runs."""
    from tpu_voice_agent_torch import ops

    inside: dict = {}
    chunk = spec.decode_chunk

    def counted(*a, **kw):
        before = ops.launch_counts()
        try:
            return chunk(*a, **kw)
        finally:
            for k, v in ops.launch_counts().items():
                inside[k] = inside.get(k, 0) + v - before[k]

    spec.decode_chunk = counted
    return inside


def _spec_delta(s0: dict, s1: dict) -> dict:
    """The speculation counters between two ``stats()`` readings."""
    d = {k: s1[k] - s0[k] for k in ("drafted", "accepted", "verify_steps", "emitted")}
    d["accept_rate"] = d["accepted"] / d["drafted"] if d["drafted"] else 0.0
    d["tokens_per_forward"] = d["emitted"] / d["verify_steps"] if d["verify_steps"] else 0.0
    return d


def _spec_parse(params, label: str, totals: dict, self_draft: bool = False):
    """The parse phase's engine (tinyllama-1.1b int8, cache 1024, bucket
    1024, the cached prefix) with ``SpecConfig(k=4)`` (``fsm,prompt``), or
    with the target as its own draft model: generate(64) p50 over bench.py's
    5 utterances after one warm-up. Returns (engine, row, results, counts,
    launches inside the decoder's chunks)."""
    import torch

    from tpu_voice_agent_torch.serve.engine import DecodeEngine
    from tpu_voice_agent_torch.serve.spec import DraftModelDrafter, SpecConfig, SpecDecoder
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    eng = DecodeEngine(preset="tinyllama-1.1b", quant="int8", max_len=1024,
                       prefill_buckets=(1024,), init_weights=False, spec=SpecConfig(k=SPEC_K))
    eng.load_params(params)
    if self_draft:
        eng.spec = SpecDecoder(eng, SpecConfig(k=SPEC_K), drafter=DraftModelDrafter(
            eng, SPEC_K, cfg=eng.cfg, params=eng.params))
    install_prompt_prefix(eng)
    eng.generate(_bench_prompt(eng, UTTERANCES[0]), max_new_tokens=64)
    inside = _count_inside(eng.spec)
    s0 = eng.spec.stats()
    walls, results = [], []
    with Counted(label, totals) as c:
        for text in UTTERANCES:
            prompt = _bench_prompt(eng, text)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.generate(prompt, max_new_tokens=64)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            results.append(res)
            fail_if(res.error is not None, f"{label}: {res.error}")
            fail_if(not (res.finished or res.steps == 64),
                    f"{label}: stopped after {res.steps} tokens without EOS")
    row = {"p50_ms": statistics.median(walls), "walls_ms": walls,
           "prefill_ms": [r.prefill_ms for r in results],
           "decode_ms": [r.decode_ms for r in results], "tokens": [r.steps for r in results],
           "forwards": [r.forwards for r in results], "launches": c.counts,
           "launches_in_decoder": dict(inside), "draft_ms": eng.spec.draft_ms,
           **_spec_delta(s0, eng.spec.stats())}
    return eng, row, results, c, inside


def phase_spec(params, totals: dict, report: dict, profile: bool = False) -> None:
    """Speculative decoding (``SPEC_ENABLE``) at full width, random weights:
    (a) the spec parse beside the parse phase's ff=8 and ff=0 numbers; (b)
    the same with the self-draft; (c) the batch cell's 32-session drain on
    the bf16 pool (K7) and the int8 pool (K9), speculation on; (d) a
    BRAIN_BATCH=8 BRAIN_PAGED=1 RADIX_ENABLE=1 SPEC_ENABLE=1 brain answering
    two /parse turns of one session. Spec output is plain greedy output, so
    every stream must equal the fast-forward-0 stream on the same weights,
    or part from it only at a near tie (``BF16_PART_ULPS``): the verify
    block's attention (K3 / K7 / K9 at T = 5) sums in another order than
    the T = 1 step's (K2 / K6 / K8). Each drain's ff=0 run and spec run
    are also repeated, to show whether their ids repeat from run to run.
    ``profile``: one spec parse and one spec batch chunk (bf16) under the
    profiler."""
    import torch

    from tpu_voice_agent_torch.models.llama import PRESETS
    from tpu_voice_agent_torch.ops.kvquant import kv_block_bytes
    from tpu_voice_agent_torch.serve.engine import DecodeEngine
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.serve.spec import SpecConfig
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    torch.backends.cuda.matmul.allow_tf32 = False
    out: dict = {}
    parse = report.get("parse", {})
    ids0 = parse.get("ff0", {}).get("token_ids")
    if ids0 is None:  # the parse phase did not run: the ff=0 parse, untimed
        plain = DecodeEngine(preset="tinyllama-1.1b", quant="int8", max_len=1024,
                             prefill_buckets=(1024,), init_weights=False)
        plain.load_params(params)
        install_prompt_prefix(plain)
        ids0 = [plain.generate(_bench_prompt(plain, t), max_new_tokens=64).token_ids
                for t in UTTERANCES]
        del plain
    for key, self_draft in (("parse", False), ("parse_self_draft", True)):
        label = f"spec {key.replace('_', ' ')}"
        eng, row, results, c, inside = _spec_parse(params, label, totals, self_draft)
        c.require("decode_block_attention_layer", "masked_argmax", "masked_argmax_advance")
        if not self_draft:
            fail_if(inside.get("decode_attention_layer", 0) > 0,
                    f"{label}: K2 launched inside the decoder's chunks")
        prompts = [eng.tokenizer.encode(_bench_prompt(eng, t), bos=True) for t in UTTERANCES]
        diverged = _partings(eng, prompts, [r.token_ids for r in results], ids0, label,
                             "spec and ff=0")
        _check_partings(diverged, label, BF16_PART_ULPS)
        row["diverged"] = diverged
        beside = {f"ff{ff}_p50_ms": parse.get(f"ff{ff}", {}).get("p50_ms") for ff in (8, 0)}
        row.update(beside)
        ff8, ff0 = (("not run" if v is None else f"{v:.2f} ms") for v in beside.values())
        log(f"[{label}] p50 {row['p50_ms']:.2f} ms over 5 (walls "
            f"{[round(w, 2) for w in row['walls_ms']]}; the parse phase's ff=8 {ff8}, ff=0 "
            f"{ff0}); tokens {row['tokens']}, "
            f"verify forwards {row['forwards']}; drafted {row['drafted']}, accepted "
            f"{row['accepted']}, accept rate {row['accept_rate']:.4f}, tokens per forward "
            f"{row['tokens_per_forward']:.4f}; host drafting {row['draft_ms']:.2f} ms in all; "
            f"{len(UTTERANCES) - len(diverged)} of {len(UTTERANCES)} equal the ff=0 ids")
        out[key] = row
        if profile and not self_draft:
            prompt = _bench_prompt(eng, UTTERANCES[1])

            def spec_parse(eng=eng, prompt=prompt):
                res = eng.generate(prompt, max_new_tokens=64)
                return f"{res.steps} tokens, {res.forwards} verify forwards + prefill"

            _profile("spec (fsm,prompt) generate(64)", spec_parse, "spec_parse", report)
        del eng

    cfg = PRESETS["tinyllama-1.1b"]
    widths = (cfg.n_layers, 128, cfg.n_kv_heads, cfg.head_dim)
    prompts = [_batch_prompt(i) for i in range(BATCH_SLOTS)]
    for tier, kernel, t1_kernel, plain_key in (
            ("off", "paged_block_attention", "paged_attention", ("batch", "ff0")),
            ("int8", "paged_block_attention_quant", "paged_attention_quant",
             ("kvquant", "int8_ff0"))):
        label = f"spec batch {'bf16' if tier == 'off' else tier}"
        kw = {} if tier == "off" else {
            "pool_blocks": 513 * kv_block_bytes(*widths, None) // kv_block_bytes(*widths, tier)}
        # the ff=0 drain twice (the earlier phase's, where it ran, and this
        # one's, untimed): do its ids repeat from run to run?
        ff0_runs = [report.get(plain_key[0], {}).get(plain_key[1], {}).get("token_ids")]
        ff0_runs = [r for r in ff0_runs if r is not None]
        while len(ff0_runs) < 2:
            plain = _paged_engine(params, 0, radix_enable=False, kv_quant=tier, **kw)
            install_prompt_prefix(plain)
            ff0_runs.append([r.token_ids for r in ContinuousBatcher(
                plain, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS).generate_many(prompts)])
            del plain
        ids_plain = ff0_runs[0]
        eng = _paged_engine(params, 0, radix_enable=False, kv_quant=tier,
                            spec=SpecConfig(k=SPEC_K), **kw)
        hold: dict = {}

        def start(eng=eng, hold=hold):
            hold["s0"] = eng.spec.stats()
            hold["inside"] = _count_inside(eng.spec)
            hold["peak"] = 0
            grow = eng._claim

            def sampled(*a, **kw):  # a spec drain may end inside one chunk
                starved = grow(*a, **kw)
                hold["peak"] = max(hold["peak"], eng.allocator.blocks_in_use)
                return starved

            eng._claim = sampled

        row, res, c = _drain(eng, label, totals, on_start=start)
        c.require(kernel, "masked_argmax", "masked_argmax_advance")
        inside = hold["inside"]
        fail_if(inside.get(t1_kernel, 0) > 0,
                f"{label}: the T = 1 kernel {t1_kernel} launched inside the decoder's chunks")
        fail_if(inside.get(kernel, 0) <= 0 or inside.get("masked_argmax", 0) <= 0,
                f"{label}: the verify steps did not launch {kernel} and masked_argmax")
        ids = [eng.tokenizer.encode(p, bos=True) for p in prompts]
        diverged = _partings(eng, ids, [r.token_ids for r in res], ids_plain, label,
                             "spec and ff=0")
        _check_partings(diverged, label, BF16_PART_ULPS)
        sd = _spec_delta(hold["s0"], eng.spec.stats())
        row_fwds = sum(r.forwards for r in res)
        row["peak_pool_blocks"] = max(row["peak_pool_blocks"], hold["peak"])
        row.update(sd, diverged=diverged, launches_in_decoder=dict(inside),
                   row_forwards=row_fwds, tokens_per_forward_per_row=row["tokens"] / row_fwds,
                   spec_accepted=sum(r.spec_accepted for r in res), draft_ms=eng.spec.draft_ms)
        log(f"[{label}] {row['intents_per_s']:.3f} intents/s, {row['tokens_per_s']:.1f} "
            f"tokens/s; {row['forwards']} verify forwards; accepted/drafted {sd['accepted']}/"
            f"{sd['drafted']} ({sd['accept_rate']:.4f}); tokens per forward per row "
            f"{row['tokens_per_forward_per_row']:.4f}; peak pool {row['peak_pool_blocks']} "
            f"blocks; {BATCH_SLOTS - len(diverged)} of {BATCH_SLOTS} equal the ff=0 drain")
        out[f"batch_{'bf16' if tier == 'off' else tier}"] = row
        # the spec drain again on the same engine: do its ids repeat?
        again = [r.token_ids for r in ContinuousBatcher(
            eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS).generate_many(prompts)]
        repeat = {"ff0_sessions_differ": [i for i, (a, b) in enumerate(zip(*ff0_runs))
                                          if a != b],
                  "spec_sessions_differ": [i for i, (a, b) in enumerate(
                      zip([r.token_ids for r in res], again)) if a != b],
                  "parting_sessions": [i for i, (a, b) in enumerate(
                      zip([r.token_ids for r in res], ids_plain)) if a != b]}
        row["repeat"] = repeat
        log(f"[{label}] run to run: the ff=0 drain's ids differ on sessions "
            f"{repeat['ff0_sessions_differ']} between two runs, the spec drain's on "
            f"{repeat['spec_sessions_differ']}; spec parts from ff=0 on "
            f"{repeat['parting_sessions']}")
        if profile and tier == "off":
            _profile_batch_chunk(eng, report, kind="spec")
        del eng
    out["service"] = _spec_service(totals)
    report["spec"] = out


def _spec_service(totals: dict) -> dict:
    """A BRAIN_BATCH=8 BRAIN_PAGED=1 RADIX_ENABLE=1 SPEC_ENABLE=1 brain from
    the environment, in-process on an ephemeral port: two /parse turns of
    one session must answer 200, turn 2 served from more cache than the
    prefix."""
    from tpu_voice_agent_torch.schemas import validate_parse_response
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
    from tpu_voice_agent_torch.services import brain

    env = dict(BRAIN_BACKEND="engine:tinyllama-1.1b", BRAIN_QUANT="int8", BRAIN_BATCH="8",
               BRAIN_PAGED="1", RADIX_ENABLE="1", SPEC_ENABLE="1")
    os.environ.update(env)
    for k in ("BRAIN_FF", "BRAIN_PREFIX", "BRAIN_DEVICE", "BRAIN_POOL_BLOCKS", "BRAIN_CHUNK",
              "KV_QUANT", "SPEC_K", "SPEC_DRAFTER", "SPEC_DRAFT_MODEL", "SPEC_TRACE_SINK"):
        os.environ.pop(k, None)
    try:
        t0 = time.perf_counter()
        parser = brain.make_parser_from_env()
    finally:
        for k in ("BRAIN_BATCH", "BRAIN_PAGED", "RADIX_ENABLE", "SPEC_ENABLE"):
            os.environ.pop(k, None)
    eng = parser.engine
    boot = time.perf_counter() - t0
    server, thread, base = _serve_brain(brain.BrainApp(parser))
    turns = []
    try:
        fail_if(not (isinstance(parser, brain.BatchedEngineParser) and parser.wants_session
                     and eng.spec is not None and isinstance(eng, PagedDecodeEngine)
                     and eng.device.type == "cuda"),
                "spec service: not a session-aware speculative paged parser on the card")
        with Counted("spec service", totals) as c:
            for text in UTTERANCES[:2]:
                headers: dict = {}
                t1 = time.perf_counter()
                status, body = _post(base, {"text": text, "session_id": "spec-session",
                                            "context": {}}, headers)
                turns.append({"text": text, "status": status, "wall_ms":
                              (time.perf_counter() - t1) * 1e3, "body": body,
                              "cached_tokens": int(headers.get("x-cached-tokens", -1))})
    finally:
        _stop(server, thread)
        parser.close()
    c.require("paged_block_attention", "masked_argmax")
    P = len(eng.prefix_ids)
    for t in turns:
        fail_if(t["status"] != 200 or validate_parse_response(t["body"]) != (t["body"], None),
                f"spec service: /parse {t['text']!r} answered {t['status']} {t['body']}")
    fail_if(turns[1]["cached_tokens"] <= P,
            f"spec service: turn 2 cached {turns[1]['cached_tokens']} tokens (prefix {P})")
    log(f"[spec service] boot {boot:.2f} s; two turns of one session answered "
        f"{[t['status'] for t in turns]} in {[round(t['wall_ms'], 1) for t in turns]} ms, "
        f"cached tokens {[t['cached_tokens'] for t in turns]} (prefix {P})")
    return {"boot_s": boot, "prefix_tokens": P, "launches": c.counts,
            "turns": [{k: v for k, v in t.items() if k != "body"} for t in turns]}


def phase_spec_golden(totals: dict, report: dict) -> None:
    """The distilled checkpoint (fp32) under speculation must reproduce the
    recorded parses (spec output is plain greedy output; the distilled
    engine runs fast-forward 0): the single-slot spec engine (``fsm,prompt``;
    K1, K3, K11, K4) and the 15-slot paged spec engine at bf16 (K7), int8
    and int4 (K9), each against its recording; then the self-draft on the
    single-slot engine, which must also accept more than 0.9 of its drafts
    at more than 2 tokens per verify step."""
    import torch
    from dataclasses import replace

    from tpu_voice_agent_torch import distilled
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.serve.spec import DraftModelDrafter, SpecConfig, SpecDecoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params = distilled.load_distilled(device="cuda")
    recs = distilled.golden_records()
    out = {}

    def single(label, self_draft):
        parser = distilled.intent_engine_from(cfg, params, device="cuda",
                                              spec=SpecConfig(k=SPEC_K))
        eng = parser.engine
        if self_draft:
            eng.spec = SpecDecoder(eng, SpecConfig(k=SPEC_K), drafter=DraftModelDrafter(
                eng, SPEC_K, cfg=eng.cfg, params=eng.params))
        bad = []
        with Counted(label, totals) as c:
            t0 = time.perf_counter()
            for rec in recs:
                resp = parser.parse(rec["text"], rec["context"])
                if parser.last_result.token_ids != rec["token_ids"] or resp != rec["response"]:
                    bad.append(rec["text"])
            wall = time.perf_counter() - t0
        c.require("flash_attention", "decode_block_attention_layer", "masked_argmax",
                  "masked_argmax_advance")
        s = eng.spec.stats()
        fail_if(bool(bad), f"{label}: {len(bad)} of {len(recs)} parses differ: {bad[:3]}")
        log(f"[{label}] {len(recs)} of {len(recs)} parses equal the recording ({wall:.2f} s); "
            f"accept rate {s['accept_rate']:.4f}, tokens per forward {s['tokens_per_step']:.4f}")
        return {"cases": len(recs), "seconds": wall, "launches": c.counts, **s}

    out["single"] = single("spec_golden single", False)
    out["self_draft"] = sd = single("spec_golden self-draft", True)
    fail_if(not (sd["accept_rate"] > 0.9 and sd["tokens_per_step"] > 2.0),
            f"spec_golden: the self-draft accepts {sd['accept_rate']:.4f} at "
            f"{sd['tokens_per_step']:.4f} tokens per forward (want > 0.9 and > 2)")
    for tier in ("off", "int8", "int4"):
        label = f"spec_golden paged {'bf16' if tier == 'off' else tier}"
        trecs = recs if tier == "off" else distilled.kvquant_golden_records()["tiers"][tier]
        eng = PagedDecodeEngine(cfg=replace(cfg, max_seq_len=512), max_len=512,
                                prefill_buckets=(64, 128), init_weights=False, device="cuda",
                                batch_slots=15, kv_quant=tier, spec=SpecConfig(k=SPEC_K))
        eng.load_params(params)
        b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=300)
        with Counted(label, totals) as c:
            t0 = time.perf_counter()
            res = b.generate_many([distilled.distilled_prompt(r["text"], r["context"])
                                   for r in trecs])
            wall = time.perf_counter() - t0
        c.require("flash_attention", "masked_argmax", "masked_argmax_advance",
                  "paged_block_attention" if tier == "off" else "paged_block_attention_quant")
        bad = [rec["text"] for rec, r in zip(trecs, res) if r.token_ids != rec["token_ids"]]
        fail_if(bool(bad), f"{label}: {len(bad)} of {len(trecs)} parses differ: {bad[:3]}")
        fail_if(eng.allocator.blocks_in_use != 0, f"{label}: blocks leaked")
        s = eng.spec.stats()
        log(f"[{label}] {len(trecs)} of {len(trecs)} batched parses equal the recording "
            f"({sum(r.steps for r in res)} tokens, {b.forwards} verify forwards, {wall:.2f} s); "
            f"accept rate {s['accept_rate']:.4f}")
        out[f"paged_{'bf16' if tier == 'off' else tier}"] = {
            "cases": len(trecs), "seconds": wall, "verify_forwards": b.forwards,
            "launches": c.counts, **s}
        del eng, b
    report["spec_golden"] = out


# ------------------------------------------------------------------ MoE

MOE_LAYERS = 32  # mixtral-8x7b: K13 runs gate, up and down in every layer
MOE_IDENTITY_PROMPTS = 4  # a depth the script's time limit sets


def _moved(tree, device):
    """A copy of a (nested dict) param tree on ``device``."""
    if isinstance(tree, dict):
        return {k: _moved(v, device) for k, v in tree.items()}
    return tree.to(device)


def _moe_identity(totals: dict) -> dict:
    """The mixtral-test engine (4 experts, top-2) in fp32 on ONE weight set,
    ff=8 behind the cached prefix, 4 prompts of 64 new tokens: the grouped
    dispatch on the card (K13) against the dense dispatch on the card (no
    K13), and against the grouped engine on the CPU (the plain versions).
    Token-identical, or parted only where the plain forward's top-2 margin
    is below one bf16 ulp of the top logit (``_check_partings`` at 1)."""
    import dataclasses

    import torch

    from tpu_voice_agent_torch.grammar import build_intent_fsm
    from tpu_voice_agent_torch.models.llama import PRESETS, init_params
    from tpu_voice_agent_torch.serve.engine import DecodeEngine
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    torch.backends.cuda.matmul.allow_tf32 = False
    base = PRESETS["mixtral-test"]
    kw = dict(max_len=1024, prefill_buckets=(1024,), fast_forward=8, init_weights=False)

    def engine(impl, device, params):
        eng = DecodeEngine(cfg=dataclasses.replace(base, moe_impl=impl), device=device, **kw)
        eng.load_params(params)
        install_prompt_prefix(eng)
        return eng

    vocab = build_intent_fsm()[0].vocab_size
    params = init_params(dataclasses.replace(base, vocab_size=vocab),
                         torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    cpu = engine("grouped", "cpu", params)
    card = _moved(params, "cuda")
    grouped, dense = engine("grouped", None, card), engine("dense", None, card)
    prompts = [_batch_prompt(i) for i in range(MOE_IDENTITY_PROMPTS)]
    ids = {}
    for label, eng in (("grouped", grouped), ("dense", dense)):
        with Counted(f"moe identity {label}", totals) as c:
            ids[label] = [eng.generate(p, max_new_tokens=64).token_ids for p in prompts]
        fail_if((c.counts["grouped_matmul"] > 0) != (label == "grouped"),
                f"moe identity: K13 launched {c.counts['grouped_matmul']} times on the "
                f"{label} dispatch")
    ids["cpu"] = [cpu.generate(p, max_new_tokens=64).token_ids for p in prompts]
    prompt_ids = [grouped.tokenizer.encode(p, bos=True) for p in prompts]
    out = {"prompts": len(prompts), "tokens": [len(t) for t in ids["grouped"]]}
    for other, what in (("dense", "grouped and dense on the card"),
                        ("cpu", "grouped on the card and on the CPU")):
        parted = _partings(grouped, prompt_ids, ids["grouped"], ids[other], "moe identity",
                           what)
        _check_partings(parted, f"moe identity ({what})", 1)
        out[f"parted_{other}"] = parted
        log(f"[moe identity] {what}: {len(prompts) - len(parted)} of {len(prompts)} prompts "
            f"token-identical ({sum(out['tokens'])} tokens)")
    return out


def _moe_boot(impl: str, totals: dict, **env):
    """make_parser_from_env() at BRAIN_BACKEND=engine:mixtral-8x7b
    BRAIN_QUANT=int8 (ff 8, the cached prefix), ``BRAIN_MOE=grouped`` for the
    grouped dispatch, plus ``env``. Returns (parser, boot seconds, launch
    counts of the boot)."""
    from tpu_voice_agent_torch.services import brain

    for k in ("BRAIN_FF", "BRAIN_PREFIX", "BRAIN_DEVICE", "BRAIN_BATCH", "BRAIN_PAGED",
              "BRAIN_POOL_BLOCKS", "RADIX_ENABLE", "KV_QUANT", "SPEC_ENABLE", "BRAIN_MOE"):
        os.environ.pop(k, None)
    os.environ.update(BRAIN_BACKEND="engine:mixtral-8x7b", BRAIN_QUANT="int8", **env)
    if impl == "grouped":
        os.environ["BRAIN_MOE"] = "grouped"
    try:
        with Counted(f"moe {impl} boot", totals) as c:
            t0 = time.perf_counter()
            parser = brain.make_parser_from_env()
            boot = time.perf_counter() - t0
    finally:
        for k in ("BRAIN_MOE", *env):
            os.environ.pop(k, None)
    eng = parser.engine
    fail_if(eng.device.type != "cuda" or eng.quant != "int8" or eng.cfg.n_experts != 8
            or eng.cfg.moe_impl != impl or not eng.prefix_ids,
            f"moe {impl}: not a mixtral-8x7b int8 {impl} engine on the card behind the prefix")
    return parser, boot, c.counts


def _free_cuda() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_moe(totals: dict, report: dict, profile: bool = False) -> None:
    """The MoE decoder behind /parse at full width: mixtral-8x7b (32 layers,
    dim 4096, 8 experts of ffn 14336, top-2), int8 weights drawn and
    quantized layer by layer on the card (the bf16 tree, ~93 GB, never
    exists), ff 8 behind the cached prefix. First the fp32 identity check at
    mixtral-test (``_moe_identity``). Then BRAIN_MOE=grouped behind BrainApp:
    2 /parse requests, each a 200 with a grammar-valid intent, K13 launched
    exactly 3 x 32 times per forward (the prefix install, and each request's
    suffix prefill and decode forwards), the peak allocation under the card's
    memory. Then the first of them on the dense dispatch (BRAIN_MOE unset, the
    same seed, so the same weights): K13 never launches; token agreement
    with the grouped parses is reported, not gated (bf16). Then
    BRAIN_PAGED=1 BRAIN_BATCH=8 grouped: an 8-session drain through K7 and
    K13. Each 46 GB engine is freed before the next is built. ``profile``
    adds one parse of each dispatch under the profiler."""
    import torch

    from tpu_voice_agent_torch.schemas import validate_parse_response
    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.utils.hbm_budget import card_bytes

    _free_cuda()
    out = {"identity": _moe_identity(totals)}
    _free_cuda()
    cap = card_bytes()
    per_forward = 3 * MOE_LAYERS
    for impl in ("grouped", "dense"):
        torch.cuda.reset_peak_memory_stats()
        parser, boot, boot_counts = _moe_boot(impl, totals)
        eng = parser.engine
        layers = eng.params["layers"]
        weights = (int(layers[-1]["moe_down"]["q"][-1].sum()),
                   float(eng.params["lm_head"]["s"].double().sum()))
        app = brain.BrainApp(parser)
        log(f"[moe {impl}] boot {boot:.2f} s (init, quantize, prefix prefill): "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; /health "
            f"{app.health()[1]}")
        fail_if(boot_counts["grouped_matmul"] != (per_forward if impl == "grouped" else 0),
                f"moe {impl}: the prefix prefill launched K13 "
                f"{boot_counts['grouped_matmul']} times")
        rows = []
        with Counted(f"moe {impl}", totals) as c:
            # the dense dispatch answers one parse (K13 never launches); the
            # grouped one two
            for text in UTTERANCES[:2 if impl == "grouped" else 1]:
                t1 = time.perf_counter()
                status, body, _ = app.parse(json.dumps({"text": text, "context": {}}).encode())
                wall = (time.perf_counter() - t1) * 1e3
                res = parser.last_result
                fail_if(status != 200 or validate_parse_response(body) != (body, None)
                        or res is None or eng.fsm.walk(res.token_ids) < 0,
                        f"moe {impl}: /parse {text!r} answered {status} {body}")
                rows.append({"text": text, "status": status, "wall_ms": wall,
                             "prompt_tokens": res.prompt_tokens,
                             "cached_tokens": res.cached_tokens, "prefill_ms": res.prefill_ms,
                             "decode_ms": res.decode_ms, "tokens": res.steps,
                             "forwards": res.forwards,
                             "ms_per_forward": res.decode_ms / max(res.forwards, 1),
                             "token_ids": res.token_ids})
                log(f"[moe {impl}] /parse 200: prompt {res.prompt_tokens} (cached "
                    f"{res.cached_tokens}) prefill {res.prefill_ms:.2f} ms decode "
                    f"{res.decode_ms:.2f} ms, {res.steps} tokens in {res.forwards} forwards "
                    f"({rows[-1]['ms_per_forward']:.2f} ms each), wall {wall:.1f} ms")
        peak = torch.cuda.max_memory_allocated()
        forwards = sum(1 + r["forwards"] for r in rows)  # a suffix prefill + decode forwards
        want = per_forward * forwards if impl == "grouped" else 0
        fail_if(c.counts["grouped_matmul"] != want,
                f"moe {impl}: K13 launched {c.counts['grouped_matmul']} times over {forwards} "
                f"forwards, want {want}")
        fail_if(peak >= cap, f"moe {impl}: peak {peak} bytes over the card's {cap}")
        out[impl] = {"boot_s": boot, "peak_bytes": peak, "card_bytes": cap, "requests": rows,
                     "forwards": forwards, "launches": c.counts, "weights": weights}
        log(f"[moe {impl}] peak allocation {peak / 2**30:.2f} of {cap / 2**30:.2f} GiB; "
            f"K13 launches {c.counts['grouped_matmul']} over {forwards} forwards")
        if profile:
            def parse():
                app.parse(json.dumps({"text": UTTERANCES[0], "context": {}}).encode())
                r = parser.last_result
                return f"{r.steps} tokens, {r.forwards} forwards + a suffix prefill"

            _profile(f"mixtral-8x7b int8 {impl} /parse", parse, f"moe_{impl}", report)
        del app, parser, eng, layers
        _free_cuda()
    fail_if(out["grouped"]["weights"] != out["dense"]["weights"],
            "moe: the grouped and dense engines drew different weights from one seed")
    agree = []
    for a, b in zip(out["grouped"]["requests"], out["dense"]["requests"]):
        ta, tb = a["token_ids"], b["token_ids"]
        same = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), min(len(ta), len(tb)))
        agree.append({"text": a["text"], "identical": ta == tb, "first_parting": same,
                      "tokens": [len(ta), len(tb)]})
    out["dense_agreement"] = agree
    log(f"[moe] grouped and dense dispatch, same weights: {agree}")

    torch.cuda.reset_peak_memory_stats()
    parser, boot, _ = _moe_boot("grouped", totals, BRAIN_PAGED="1", BRAIN_BATCH="8")
    parser.close()  # the drain steps its own batcher on the engine
    eng = parser.engine
    fail_if(eng.batch_slots != 8 or eng.allocator is None, "moe paged: not an 8-slot paged engine")
    row, _res, c = _drain(eng, "moe paged", totals, sessions=8)
    c.require("paged_block_attention", "grouped_matmul", "masked_argmax_advance")
    fail_if(c.counts["grouped_matmul"] % per_forward,
            f"moe paged: {c.counts['grouped_matmul']} K13 launches, not whole forwards")
    row.update(boot_s=boot, peak_bytes=torch.cuda.max_memory_allocated())
    out["paged"] = row
    out["kvquant"] = _moe_kvquant(eng, _res, totals)
    del parser, eng, _res
    _free_cuda()
    out["kvquant_fp32"] = _moe_kvquant_fp32(totals)
    report["moe"] = out


# bytes a (position, kv head) of the pool, values and scale, at head dim 128
MOE_KV_BYTES = {None: 256, "int8": 130, "int4": 66}


def _moe_health(eng, tier) -> dict:
    """``/health`` of a brain around ``eng`` (HBM_LEDGER_S=0: this engine's
    ledger): ``compile_sentinel`` and ``hbm`` present, the pool at
    ``MOE_KV_BYTES`` a (position, kv head), ``hbm.plan_drift`` within
    ``HBM_DRIFT_WARN``."""
    from tpu_voice_agent_torch.services import brain

    parser = brain.BatchedEngineParser(eng, max_new_tokens=BATCH_NEW_TOKENS)
    try:
        status, body, _ = brain.BrainApp(parser).health()
    finally:
        parser.close()
    hbm, cfg = body.get("hbm", {}), eng.cfg
    slots = 2 * cfg.n_layers * eng.allocator.n_blocks * eng.block_size * cfg.n_kv_heads
    per = hbm.get("hbm.kv_pool_bytes", 0) / slots
    drift, warn = hbm.get("hbm.plan_drift"), float(os.environ.get("HBM_DRIFT_WARN", "0.15"))
    label = f"moe health {tier or 'bf16'}"
    log(f"[{label}] /health {status}: kv_pool_bytes {hbm.get('hbm.kv_pool_bytes')} = {per:g} "
        f"a (position, kv head), weights {hbm.get('hbm.weights_bytes')}, workspace "
        f"{hbm.get('hbm.workspace_bytes')}, live {hbm.get('hbm.live_bytes')}, free "
        f"{hbm.get('hbm.free_bytes')}, plan drift {drift}; compile sentinel "
        f"{body.get('compile_sentinel')}")
    fail_if(status != 200 or "compile_sentinel" not in body or per != MOE_KV_BYTES[tier]
            or drift is None or abs(drift) > warn,
            f"{label}: /health {status}, {per:g} bytes a (position, kv head) (want "
            f"{MOE_KV_BYTES[tier]}), plan drift {drift} (warn {warn})")
    return {"kv_pool_bytes": hbm["hbm.kv_pool_bytes"], "bytes_per_position_head": per,
            "plan_drift": drift, "weights_bytes": hbm["hbm.weights_bytes"],
            "workspace_bytes": hbm.get("hbm.workspace_bytes"),
            "live_bytes": hbm.get("hbm.live_bytes"), "free_bytes": hbm.get("hbm.free_bytes")}


def _moe_kvquant(base, bf16_res, totals: dict) -> dict:
    """KV_QUANT at head dim 128 on the MoE brain: engines over the 8-slot
    paged mixtral-8x7b engine's weight tensors (one weight set, a pool each:
    the same slots, blocks and block count), int8 and int4 at ff 8 (K9 on
    the chains) and int8 at ff 0 (K8), each an 8-session drain whose answers
    are all ok and in the grammar; K6 and K7 never launch, K13 does. At ff 8
    the sessions whose ids equal the bf16 drain's (the same weights) are
    counted with each parting step, not gated. ``/health`` of a brain
    around each engine (``_moe_health``): bf16, int8, int4 at 256, 130, 66
    bytes a (position, kv head)."""
    from tpu_voice_agent_torch.ops.kvquant import kv_block_bytes
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine

    cfg, ff8 = base.cfg, base.fast_forward
    bf16_ids = [r.token_ids for r in bf16_res]
    old = os.environ.get("HBM_LEDGER_S")
    os.environ["HBM_LEDGER_S"] = "0"  # each /health exports its own engine's ledger
    try:
        out = {"health_bf16": _moe_health(base, None)}
        for tier, ff, kernel in (("int8", ff8, "paged_block_attention_quant"),
                                 ("int4", ff8, "paged_block_attention_quant"),
                                 ("int8", 0, "paged_attention_quant")):
            label = f"moe kvquant {tier} ff={ff}"
            eng = PagedDecodeEngine(cfg=cfg, quant="int8", fast_forward=ff,
                                    max_len=base.max_len, batch_slots=base.batch_slots,
                                    prefill_buckets=base.prefill_buckets,
                                    block_size=base.block_size,
                                    pool_blocks=base.allocator.n_blocks, kv_quant=tier,
                                    radix_enable=False, init_weights=False)
            eng.load_params(base.params)
            fail_if(eng.params["lm_head"] is not base.params["lm_head"]
                    or eng.cfg.head_dim != 128 or eng.kv_quant != tier,
                    f"{label}: not a head-dim-128 {tier} pool over the bf16 engine's weights")
            row, res, c = _drain(eng, label, totals, sessions=8)
            c.require(kernel, "grouped_matmul", "masked_argmax_advance")
            for bf in ("paged_attention", "paged_block_attention"):
                fail_if(c.counts.get(bf, 0) > 0, f"{label}: the bf16 kernel {bf} launched")
            row.update(kv_bytes_per_block=eng.kv_bytes_per_block,
                       kv_block_bytes=kv_block_bytes(cfg.n_layers, eng.block_size,
                                                     cfg.n_kv_heads, cfg.head_dim, tier))
            if ff == ff8:  # the bf16 drain ran at ff 8: fast-forward changes the stream
                parts = [next((j for j, (x, y) in enumerate(zip(r.token_ids, ids)) if x != y),
                              min(len(ids), len(r.token_ids)))
                         for r, ids in zip(res, bf16_ids) if r.token_ids != ids]
                row.update(same_as_bf16=len(res) - len(parts), parting_steps=parts)
                log(f"[{label}] {row['same_as_bf16']} of {len(res)} sessions decode the bf16 "
                    f"drain's ids (parting steps {parts}); {eng.kv_bytes_per_block} bytes a "
                    "block")
                row["health"] = _moe_health(eng, tier)
            out[f"{tier}_ff{ff}"] = row
            del eng, res
            _free_cuda()
    finally:
        if old is None:
            os.environ.pop("HBM_LEDGER_S", None)
        else:
            os.environ["HBM_LEDGER_S"] = old
    return out


MOE_TWIN_PROMPTS = 2  # a depth the script's time limit sets
MOE_TWIN_NEW_TOKENS = 48


def _moe_kvquant_fp32(totals: dict) -> dict:
    """The quantized drains' fp32-activation twin: mixtral-8x7b's attention
    widths (dim 4096, 32/8 heads of 128, 8 experts, top-2), cut to 2 layers
    and ffn 512 so that a CPU engine runs it too; fp32 weights from a seed,
    one weight set, BRAIN_MOE=grouped, a 4-slot paged pool behind the cached
    prefix, ff 8. Per tier (int8, int4) the card's engine (K9, K13) against
    the same engine on the CPU (the plain versions), 4 prompts of 48 new
    tokens: token-identical, or parted only where the plain forward's
    top-2 margin is within one bf16 ulp (``_check_partings`` at 1)."""
    import dataclasses

    import torch

    from tpu_voice_agent_torch.grammar import build_intent_fsm
    from tpu_voice_agent_torch.models.llama import PRESETS, init_params
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(PRESETS["mixtral-8x7b"], n_layers=2, ffn_dim=512,
                              moe_impl="grouped")
    vocab = build_intent_fsm()[0].vocab_size
    params = init_params(dataclasses.replace(cfg, vocab_size=vocab),
                         torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    card = _moved(params, "cuda")
    prompts = [_batch_prompt(i) for i in range(MOE_TWIN_PROMPTS)]
    kw = dict(cfg=cfg, max_len=1024, batch_slots=MOE_TWIN_PROMPTS, prefill_buckets=(1024,),
              fast_forward=8, init_weights=False, radix_enable=False)
    out = {"cut": "mixtral-8x7b at 2 of 32 layers, ffn 512 of 14336, fp32 weights",
           "prompts": len(prompts)}
    for tier in ("int8", "int4"):
        label = f"moe kvquant fp32 {tier}"
        ids = {}
        for side, tree in (("card", card), ("cpu", params)):
            eng = PagedDecodeEngine(kv_quant=tier, device=None if side == "card" else "cpu",
                                    **kw)
            eng.load_params(tree)
            install_prompt_prefix(eng)
            with Counted(f"{label} {side}", totals if side == "card" else {}) as c:
                res = ContinuousBatcher(eng, chunk_steps=16,
                                        max_new_tokens=MOE_TWIN_NEW_TOKENS).generate_many(prompts)
            fail_if(any(r.error is not None for r in res), f"{label} {side}: a request failed")
            ids[side] = [r.token_ids for r in res]
            if side == "card":
                c.require("paged_block_attention_quant", "grouped_matmul")
                card_eng = eng
            else:
                fail_if(sum(c.counts.values()) > 0, f"{label}: the CPU engine launched a kernel")
        prompt_ids = [card_eng.tokenizer.encode(p, bos=True) for p in prompts]
        parted = _partings(card_eng, prompt_ids, ids["card"], ids["cpu"], label,
                           "the card and the CPU")
        _check_partings(parted, label, 1)
        out[tier] = {"tokens": [len(t) for t in ids["card"]], "parted": parted}
        log(f"[{label}] {len(prompts) - len(parted)} of {len(prompts)} prompts token-identical "
            f"on the card and the CPU ({sum(out[tier]['tokens'])} tokens)")
        del card_eng
    return out


# ------------------------------------------------------------ tenancy

# two classes: premium with a slot cap, free with a rate limit (burst 4)
TENANCY_CLASSES = "premium:4:slots=24,free:1:rps=4"
TENANCY_FLOOD = 16  # free-tenant requests submitted at once


def _tenant_run(eng, tenants: list, chunk_steps: int = 16):
    """The batch phase's prompts through a ContinuousBatcher under
    ``TENANCY_CLASSES``, prompt i tagged ``tenants[i]``, all submitted at
    once. Returns (batcher, {prompt index: result})."""
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher

    b = ContinuousBatcher(eng, chunk_steps=chunk_steps, max_new_tokens=BATCH_NEW_TOKENS)
    fail_if(b.tenancy is None, "tenancy: the plane was not built")
    rids = {i: b.submit(_batch_prompt(i), tenant=t) for i, t in enumerate(tenants)}
    b.run_until_done()
    return b, {i: b.results.pop(r) for i, r in rids.items()}


def _ledgers_conserved(results, totals_: dict, label: str) -> dict:
    from tpu_voice_agent_torch.utils.costmodel import LEDGER_KEYS, zero_ledger

    summed = zero_ledger()
    for r in results:
        fail_if(r.cost is None, f"{label}: a result has no cost ledger")
        for k in LEDGER_KEYS:
            summed[k] += r.cost[k]
    fail_if(summed != totals_, f"{label}: sum of the ledgers {summed} != the totals {totals_}")
    return summed


def _tenancy_preempt(eng, clean: dict, label: str, totals: dict, ulps: float) -> dict:
    """32 untagged (``default``) requests, then two premium and two free
    ones, submitted at once: the first 32 fill the batch (every lane's clock
    at 0, FIFO); at the next chunk boundaries (chunks of 4 steps, shorter
    than any answer) a starved lane that is poorer preempts one default slot
    each (warm release into its namespace, requeued at the head). Every
    request, the preempted ones too, decodes the untenanted run's tokens
    (chunks of 16), or parts at a near tie (``ulps``); the tenant ledgers
    sum to the meter's totals."""
    from tpu_voice_agent_torch.utils.costmodel import LEDGER_KEYS, zero_ledger

    ids = [eng.tokenizer.encode(_batch_prompt(i), bos=True) for i in range(BATCH_SLOTS + 4)]
    tenants = [None] * BATCH_SLOTS + ["premium", "premium", "free", "free"]
    with Counted(label, totals) as c:
        b, res = _tenant_run(eng, tenants, chunk_steps=4)
    c.require("masked_argmax_advance")
    fail_if(any(r.error for r in res.values()), f"{label}: {[r.error for r in res.values()]}")
    snap = b.tenancy.snapshot()
    pre = snap["lanes"]["default"]["preemptions"]
    fail_if(pre < 2, f"{label}: {pre} requests preempted, want one a starved lane")
    order = sorted(res)
    diverged = _partings(eng, [ids[i] for i in order], [clean[i].token_ids for i in order],
                         [res[i].token_ids for i in order], label, "preempted and clean")
    _check_partings(diverged, label, ulps)
    summed = zero_ledger()
    for ent in snap["ledgers"].values():
        for k in LEDGER_KEYS:
            summed[k] += ent[k]
    fail_if(summed != b.costs.totals, f"{label}: tenant ledgers {summed} != totals "
            f"{b.costs.totals}")
    resumed = [i for i in order if res[i].cached_tokens > clean[i].cached_tokens]
    log(f"[{label}] {pre} preemptions; {len(order) - len(diverged)}/{len(order)} requests "
        f"equal to the untenanted run (partings at {[round(_ulps(d), 3) for d in diverged]} "
        f"bf16 ulps); {len(resumed)} re-admitted warm past the prefix; tenant ledgers == "
        f"totals")
    return {"preemptions": pre, "equal": len(order) - len(diverged),
            "requests": len(order), "partings_ulps": [round(_ulps(d), 3) for d in diverged],
            "resumed_warm": len(resumed), "launches": c.counts,
            "lanes": {k: {f: v[f] for f in ("tokens", "preemptions", "throttled")}
                      for k, v in snap["lanes"].items()}}


def phase_tenancy(params, totals: dict, report: dict) -> None:
    """The tenancy plane on the batch phase's engine (tinyllama-1.1b int8,
    32 paged slots, radix on), ``TENANT_CLASSES`` = ``TENANCY_CLASSES``: with
    the knob unset the batcher builds no plane and its per-request ledgers
    sum to the meter's totals; on, the 32 prompts split over premium (its
    24-slot cap binding) and the default class decode the unset run's
    tokens bit for bit (K7, ff 8); a flood of 16 free requests admits the
    bucket's 4 and sheds 12 with JAX's ``shed: tenant free rate-limited``;
    preemption at ff 0 (K6) in bf16 and in a twin with fp32 activations
    (``_tenancy_preempt``); then a batched brain over HTTP with the plane
    on: ``x-tenant`` lanes a parse and ``/debug/costs`` reports
    ``engine.mfu`` / ``engine.mbu`` against the card's data sheet peak."""
    import torch

    from tpu_voice_agent_torch.utils.tracing import get_metrics

    out = {}
    os.environ.pop("TENANT_CLASSES", None)
    eng = _paged_engine(params, 8, radix_enable=True)
    _install(eng)
    with Counted("tenancy off", totals) as c:
        b_off, off = _run32(eng)
    c.require("paged_block_attention", "masked_argmax_advance")
    fail_if(b_off.tenancy is not None or any(r.error for r in off), "tenancy off: failed")
    out["off_ledgers"] = _ledgers_conserved(off, b_off.costs.totals, "tenancy off")
    os.environ["TENANT_CLASSES"] = TENANCY_CLASSES
    try:
        tenants = ["premium" if i % 4 else None for i in range(BATCH_SLOTS)]
        with Counted("tenancy on", totals) as c:
            b_on, on = _tenant_run(eng, tenants)
        c.require("paged_block_attention", "masked_argmax_advance")
        same = sum(on[i].token_ids == off[i].token_ids for i in range(BATCH_SLOTS))
        fail_if(same != BATCH_SLOTS, f"tenancy on: {same}/{BATCH_SLOTS} bit-equal to off")
        _ledgers_conserved(list(on.values()), b_on.costs.totals, "tenancy on")
        log(f"[tenancy] on ({TENANCY_CLASSES}, 24 premium + 8 default): {same}/{BATCH_SLOTS} "
            "equal to the unset run; ledgers == totals")
        thr0 = get_metrics().snapshot()["counters"].get("tenant.throttled", 0.0)
        with Counted("tenancy flood", totals):
            b_fl, flood = _tenant_run(eng, ["free"] * TENANCY_FLOOD)
        shed = [r for r in flood.values() if r.error]
        fail_if(len(shed) != TENANCY_FLOOD - 4 or any(
            r.error != "shed: tenant free rate-limited" for r in shed),
            f"tenancy flood: {len(shed)} shed: {[r.error for r in shed][:3]}")
        fail_if(get_metrics().snapshot()["counters"]["tenant.throttled"] - thr0
                != TENANCY_FLOOD - 4, "tenancy flood: tenant.throttled did not count the sheds")
        log(f"[tenancy] flood: {TENANCY_FLOOD} free requests, 4 decoded, {len(shed)} shed "
            f"'{shed[0].error}'")
        out["on"] = {"equal": same, "flood_shed": len(shed), "flood_ok": len(flood) - len(shed)}
        del eng
        _free_cuda()
        for dtype, p in (("bf16", params), ("fp32", None)):
            if dtype == "fp32":
                torch.backends.cuda.matmul.allow_tf32 = False
                p = _fp32_activations(params)
            eng0 = _paged_engine(p, 0, radix_enable=True)
            _install(eng0)
            os.environ.pop("TENANT_CLASSES", None)
            _b, clean = _run32(eng0, [_batch_prompt(i) for i in range(BATCH_SLOTS + 4)])
            fail_if(any(r.error for r in clean), f"tenancy {dtype}: the clean run failed")
            os.environ["TENANT_CLASSES"] = TENANCY_CLASSES
            out[f"preempt_{dtype}"] = _tenancy_preempt(
                eng0, dict(enumerate(clean)), f"tenancy preempt {dtype}", totals,
                1 if dtype == "fp32" else BF16_PART_ULPS)
            del eng0, p
            _free_cuda()
        out["service"] = _tenancy_service(params, totals)
    finally:
        os.environ.pop("TENANT_CLASSES", None)
    report["tenancy"] = out


def _tenancy_service(params, totals: dict) -> dict:
    """A BatchedEngineParser (8 paged slots) behind the brain with the plane
    on: one parse tagged ``x-tenant: premium``, one with the body's
    ``tenant: free``; ``/debug/costs`` answers the meter (the card's data
    sheet peak, MFU and MBU above 0, integer totals) and the lanes."""
    from tpu_voice_agent_torch.services import brain

    eng = _paged_engine(params, 8, batch_slots=8, radix_enable=True)
    _install(eng)
    parser = brain.BatchedEngineParser(eng, chunk_steps=16)
    srv, thread, url = _serve_brain(brain.BrainApp(parser))
    try:
        with Counted("tenancy service", totals) as c:
            s1, _ = _post(url, {"text": UTTERANCES[0], "session_id": "t1"},
                          send={"x-tenant": "premium"})
            s2, _ = _post(url, {"text": UTTERANCES[1], "tenant": "free", "session_id": "t2"})
        c.require("masked_argmax_advance")
        fail_if(s1 not in (200, 422) or s2 not in (200, 422), f"tenancy service: {s1}, {s2}")
        with urllib.request.urlopen(url + "/debug/costs", timeout=60) as r:
            costs = json.loads(r.read())
    finally:
        _stop(srv, thread)
        parser.close()
    peak = costs.get("peak", {})
    fail_if(not costs.get("enabled") or peak.get("source") != "table"
            or "H100" not in str(peak.get("device")), f"tenancy service: /debug/costs {peak}")
    fail_if(not (costs["mfu"] > 0 and costs["mbu"] > 0), "tenancy service: no MFU / MBU")
    fail_if(not all(isinstance(v, int) for v in costs["totals"].values()),
            "tenancy service: totals not ints")
    lanes = costs["tenants"]["lanes"]
    fail_if(lanes["premium"]["tokens"] <= 0 or lanes["free"]["tokens"] <= 0,
            f"tenancy service: a tagged parse missed its lane: {lanes}")
    log(f"[tenancy] /debug/costs: mfu {costs['mfu']}, mbu {costs['mbu']}, mfu_prefill "
        f"{costs['mfu_prefill']} against {peak['device']} ({peak['flops_per_s']:.3g} FLOP/s, "
        f"{peak['bytes_per_s']:.3g} B/s, {peak['source']}); lanes "
        + json.dumps({k: v["tokens"] for k, v in lanes.items()}))
    return {"status": [s1, s2], "mfu": costs["mfu"], "mbu": costs["mbu"],
            "mfu_prefill": costs["mfu_prefill"], "peak": peak, "totals": costs["totals"],
            "top_sessions": [t["session"] for t in costs.get("top_sessions", [])],
            "launches": c.counts}


# ------------------------------------------------------------ batched STT

# ------------------------------------------------------------------ handoff

HANDOFF_SESSIONS = 2  # a depth the script's time limit sets
HANDOFF_NEW_TOKENS = 32
HANDOFF_TURNS = [("search for wireless headphones", {}),
                 ("open the second result", {"last_query": "wireless headphones"})]
HANDOFF_TURN3 = ("sort these by price from low to high", {"last_query": "wireless headphones"})
STALL_TEXT = "decode step stalled; engine warm-restarted, work failed fast"


def _warm_engine(params, tier: str = "off"):
    """The phase's engine: bench_batch.py's paged shape, radix on, buckets
    up to 2048, the cached prefix installed."""
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    eng = _paged_engine(params, 8, radix_enable=True, prefill_buckets=RADIX_BUCKETS,
                        kv_quant=tier)
    install_prompt_prefix(eng)
    return eng


def _leaked(eng) -> int:
    """Blocks held by neither the prefix nor the tree once every slot is
    released (the prefix's blocks are the tree's pinned root)."""
    return eng.allocator.blocks_in_use - eng.radix.nodes


def _post_bytes(url: str, data: bytes, headers: dict | None = None) -> tuple[int, dict]:
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": "application/octet-stream",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _admitting_step(eng, prompts: list, label: str, totals: dict):
    """``prompts`` submitted at once to a fresh batcher, drained; returns
    (results, the admitting step's ledger entry, launch counts). That step
    admits every prompt (its first tokens picked): its wall is the batch's
    time to the last first token."""
    import torch

    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.utils.steplog import get_steplog

    b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=HANDOFF_NEW_TOKENS)
    with Counted(label, totals) as c:
        torch.cuda.synchronize()
        get_steplog().clear()
        rids = [b.submit(p) for p in prompts]
        b.step()
        first = get_steplog().last()
        b.run_until_done()
    res = [b.results.pop(r) for r in rids]
    fail_if(any(r.error for r in res), f"{label}: {[r.error for r in res if r.error][:2]}")
    fail_if(first is None or first.get("admitted") != len(prompts),
            f"{label}: the first step admitted {first and first.get('admitted')}")
    return res, first, c


def _handoff_tier(params, tier: str, totals: dict, ulps: float, label: str) -> dict:
    """2 sessions x 2 turns on a donor, each exported and POSTed to
    ``/admin/handoff`` on a brain around the recipient, turn 3 batched on
    both; then the same recipient warm-restarted, the ``HANDOFF_KV=0`` blobs
    adopted, turn 3 again (the cold baseline)."""
    import torch

    from tpu_voice_agent_torch.serve import handoff
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    def counters():
        c = get_metrics().snapshot()["counters"]
        return {k: c.get(k, 0.0) for k in ("handoff.sessions_exported", "handoff.sessions_adopted",
                                            "handoff.adopt_fallbacks", "handoff.tokens_adopted")}

    c0 = counters()
    donor, recip = _warm_engine(params, tier), _warm_engine(params, tier)
    P = len(donor.prefix_ids)
    tr_d = brain.SessionTranscripts(donor.tokenizer)
    sids = [f"handoff-{i}" for i in range(HANDOFF_SESSIONS)]
    b = ContinuousBatcher(donor, chunk_steps=16, max_new_tokens=HANDOFF_NEW_TOKENS)
    for t, (text, ctx) in enumerate(HANDOFF_TURNS):
        prompts = [tr_d.prompt_for(sid, f"{text} ({sid})", ctx) for sid in sids]
        for sid, p, r in zip(sids, prompts, b.generate_many(prompts)):
            fail_if(r.error is not None, f"{label}: {sid} turn {t + 1}: {r.error}")
            tr_d.record(sid, p, r.token_ids)
    blobs, cold_blobs, export_ms = [], [], []
    for sid in sids:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blobs.append(handoff.export_session(donor, tr_d, sid))
        export_ms.append((time.perf_counter() - t0) * 1e3)
        os.environ["HANDOFF_KV"] = "0"
        try:
            cold_blobs.append(handoff.export_session(donor, tr_d, sid))
        finally:
            os.environ.pop("HANDOFF_KV", None)
    shipped = []
    for blob in blobs:
        arrays = handoff.unpack(blob)[1]
        shipped.append(int(arrays["k"].shape[1]) if arrays else 0)
    fail_if(min(shipped) < 1, f"{label}: a session shipped no block past the prefix")
    text3, ctx3 = HANDOFF_TURN3
    prompts3 = [tr_d.prompt_for(sid, f"{text3} ({sid})", ctx3) for sid in sids]
    stay, stay_step, _ = _admitting_step(donor, prompts3, f"{label} donor turn 3", totals)

    parser = brain.BatchedEngineParser(recip, max_new_tokens=HANDOFF_NEW_TOKENS,
                                       session_aware=True)
    srv, thread, url = _serve_brain(brain.BrainApp(parser))
    adopt_ms, adopted = [], []
    try:
        for blob in blobs:
            t0 = time.perf_counter()
            status, body = _post_bytes(url + "/admin/handoff", blob)
            adopt_ms.append((time.perf_counter() - t0) * 1e3)
            fail_if(status != 200 or not body.get("ok"), f"{label}: adopt {status} {body}")
            adopted.append(body["adopted_tokens"])
    finally:
        _stop(srv, thread)
        parser.close()
    fail_if(min(adopted) <= P, f"{label}: a session adopted cold ({adopted}, prefix {P})")
    prompts_r = [parser.transcripts.prompt_for(sid, f"{text3} ({sid})", ctx3) for sid in sids]
    fail_if(prompts_r != prompts3, f"{label}: the recipient renders another turn 3")
    moved, moved_step, c = _admitting_step(recip, prompts_r, f"{label} recipient turn 3", totals)
    c.require("paged_block_attention" if tier == "off" else "paged_block_attention_quant",
              "masked_argmax_advance")
    ids = [recip.tokenizer.encode(p, bos=True) if isinstance(p, str) else list(p)
           for p in prompts3]
    diverged = _partings(recip, ids, [r.token_ids for r in stay], [r.token_ids for r in moved],
                         label, "donor and recipient turn 3")
    _check_partings(diverged, label, ulps)
    fail_if([r.cached_tokens for r in moved] != [r.cached_tokens for r in stay],
            f"{label}: the recipient served other cached spans than the donor")
    leaked = {"donor": _leaked(donor), "recipient": _leaked(recip)}
    fail_if(any(leaked.values()), f"{label}: leaked blocks {leaked}")

    # the cold baseline: the same recipient, warm-restarted, transcripts only
    recip.warm_restart()
    fail_if(recip.allocator.blocks_in_use != len(recip._prefix_blocks),
            f"{label}: warm_restart kept {recip.allocator.blocks_in_use} blocks")
    tr_c = brain.SessionTranscripts(recip.tokenizer)
    for blob in cold_blobs:
        fail_if(handoff.adopt_session(recip, tr_c, blob) != 0, f"{label}: a cold blob went warm")
    cold, cold_step, _ = _admitting_step(recip, prompts3, f"{label} cold turn 3", totals)
    cold_div = _partings(recip, ids, [r.token_ids for r in stay], [r.token_ids for r in cold],
                         label, "donor and cold recipient turn 3")
    _check_partings(cold_div, label, ulps)
    fail_if(_leaked(recip), f"{label}: the cold run leaked blocks")
    d = {k: v - c0[k] for k, v in counters().items()}
    fail_if(d["handoff.sessions_exported"] != 2 * HANDOFF_SESSIONS
            or d["handoff.sessions_adopted"] != 2 * HANDOFF_SESSIONS
            or d["handoff.adopt_fallbacks"] != 0, f"{label}: counters {d}")
    row = {
        "tier": tier, "sessions": HANDOFF_SESSIONS, "prefix_tokens": P,
        "blob_bytes": [len(x) for x in blobs], "blocks_shipped": shipped,
        "bytes_per_block": sum(len(x) for x in blobs) / max(1, sum(shipped)),
        "cold_blob_bytes": [len(x) for x in cold_blobs],
        "export_ms": export_ms, "adopt_ms": adopt_ms, "adopted_tokens": adopted,
        "turn3_cached_warm": [r.cached_tokens for r in moved],
        "turn3_cached_cold": [r.cached_tokens for r in cold],
        # every session's first token: the admitting step's admit + prefill stages
        "ttft_ms": {k: st["stages"]["admit"] + st["stages"]["prefill"]
                    for k, st in (("donor", stay_step), ("warm", moved_step), ("cold", cold_step))},
        "admitting_stages_ms": {"donor": stay_step["stages"], "warm": moved_step["stages"],
                                "cold": cold_step["stages"]},
        "equal": HANDOFF_SESSIONS - len(diverged), "partings": diverged,
        "cold_equal": HANDOFF_SESSIONS - len(cold_div), "counters": d, "leaked": leaked,
        "launches": c.counts}
    log(f"[{label}] {HANDOFF_SESSIONS} sessions: blob {statistics.median(row['blob_bytes']):.0f} "
        f"bytes p50 ({row['bytes_per_block']:.0f} a shipped block, {sum(shipped)} blocks), "
        f"export p50 {statistics.median(export_ms):.2f} ms, adopt over HTTP p50 "
        f"{statistics.median(adopt_ms):.2f} ms; turn 3 equal {row['equal']}/{HANDOFF_SESSIONS} "
        f"(cold {row['cold_equal']}), cached warm {sorted(set(row['turn3_cached_warm']))} cold "
        f"{sorted(set(row['turn3_cached_cold']))}; the first tokens (admit + prefill) donor "
        f"{row['ttft_ms']['donor']:.2f} / warm {row['ttft_ms']['warm']:.2f} / cold "
        f"{row['ttft_ms']['cold']:.2f} ms, of it prefill "
        f"{stay_step['stages']['prefill']:.2f} / {moved_step['stages']['prefill']:.2f} / "
        f"{cold_step['stages']['prefill']:.2f}; counters {d}; leaked {leaked}")
    del donor, recip
    _free_cuda()
    return row


DISAGG_TEXT = "search for wireless noise cancelling headphones and sort by rating"
# a long transcript in the context: the prompt runs ~1,000 tokens past the
# cached prefix, so its export takes more than one 4-block chunk
DISAGG_CONTEXT = {"last_query": "usb c hub", "page": "results",
                  "history": [f"step {i}: compared item number {i} against the shortlist and "
                              "kept the cheaper one" for i in range(17)]}


def _read_frames(base: str, body: dict):
    """POST /admin/disagg/prefill; each frame as it arrives: (status,
    headers, [(seq, payload, final, seconds since the request)], wall)."""
    import http.client
    from urllib.parse import urlparse

    from tpu_voice_agent_torch.serve import handoff

    u = urlparse(base)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", "/admin/disagg/prefill", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.getheader("Content-Type", "").startswith("application/json"):
        body = resp.read()
        conn.close()
        raise SmokeFailure(f"disagg prefill answered {resp.status} JSON, no stream: {body[:300]}")
    frames, buf = [], b""
    while True:
        chunk = resp.read1(1 << 20)
        if not chunk:
            break
        buf += chunk
        got, buf = handoff.frame_feed(buf)
        frames.extend((s, p, f, time.perf_counter() - t0) for s, p, f in got)
    conn.close()
    return resp.status, dict(resp.headers), frames, time.perf_counter() - t0


def _disagg(params, totals: dict, ulps: float, label: str) -> dict:
    """The disagg stream between two port brains on the card, then the
    decode brain's parse of the prompt against a cold engine's."""
    from tpu_voice_agent_torch.serve import handoff
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services import brain

    from tpu_voice_agent_torch.services.prompts import render_prompt

    pf_eng, dec_eng = _warm_engine(params), _warm_engine(params)
    prompt = render_prompt(DISAGG_TEXT, DISAGG_CONTEXT)
    n_ids = len(pf_eng.tokenizer.encode(prompt, bos=True))
    pf = brain.BatchedEngineParser(pf_eng, max_new_tokens=HANDOFF_NEW_TOKENS, session_aware=True)
    dec = brain.BatchedEngineParser(dec_eng, max_new_tokens=HANDOFF_NEW_TOKENS,
                                    session_aware=True)
    psrv, pthread, purl = _serve_brain(brain.BrainApp(pf))
    dsrv, dthread, durl = _serve_brain(brain.BrainApp(dec))
    try:
        with Counted(f"{label} export", totals) as c_pf:
            status, headers, frames, wall = _read_frames(purl, {
                "text": DISAGG_TEXT, "context": DISAGG_CONTEXT, "stream_blocks": 4,
                "stream": "disagg-1"})
        fail_if(status != 200 or not frames or not frames[-1][2],
                f"{label}: stream {status}, {len(frames)} frames")
        meta, _ = handoff.unpack(frames[-1][1])
        fail_if(not meta.get("ok") or meta.get("segments") != len(frames) - 1,
                f"{label}: the kv_end summary {meta}")
        adopt_ms = []
        with Counted(f"{label} adopt", totals):
            for _, payload, final, _ in frames:
                t0 = time.perf_counter()
                st, out = _post_bytes(durl + "/admin/disagg/adopt", payload,
                                      {"x-disagg-stream": "disagg-1"})
                adopt_ms.append((time.perf_counter() - t0) * 1e3)
                fail_if(st != 200 or not out.get("ok") or out.get("final") != final,
                        f"{label}: adopt {st} {out}")
        fail_if(out["adopted_tokens"] != meta["chain_tokens"],
                f"{label}: adopted {out['adopted_tokens']} of {meta['chain_tokens']} tokens")
        with Counted(f"{label} warm parse", totals) as c:
            warm = dec.loop.submit(prompt).result(timeout=600)
        c.require("paged_block_attention", "masked_argmax_advance")
    finally:
        _stop(psrv, pthread)
        _stop(dsrv, dthread)
        pf.close()
        dec.close()
    fail_if(warm.error is not None, f"{label}: {warm.error}")
    fail_if(warm.cached_tokens < meta["chain_tokens"],
            f"{label}: the parse cached {warm.cached_tokens} of {meta['chain_tokens']}")
    leaked = {"prefill": _leaked(pf_eng), "decode": _leaked(dec_eng)}
    fail_if(any(leaked.values()), f"{label}: leaked blocks {leaked}")
    del pf_eng, dec_eng
    cold_eng = _warm_engine(params)
    cold = ContinuousBatcher(cold_eng, chunk_steps=16,
                             max_new_tokens=HANDOFF_NEW_TOKENS).generate_many([prompt])[0]
    ids = cold_eng.tokenizer.encode(prompt, bos=True)
    diverged = _partings(cold_eng, [ids], [cold.token_ids], [warm.token_ids], label,
                         "the adopted and the cold parse")
    _check_partings(diverged, label, ulps)
    row = {"prompt_tokens": n_ids, "frames": len(frames), "segments": meta["segments"],
           "chain_tokens": meta["chain_tokens"], "frame_bytes": [len(p) for _, p, _, _ in frames],
           "first_frame_s": frames[0][3], "export_wall_s": wall,
           "frame_arrivals_s": [t for *_, t in frames], "adopt_ms": adopt_ms,
           "warm_cached_tokens": warm.cached_tokens, "cold_cached_tokens": cold.cached_tokens,
           "equal": not diverged, "partings": diverged, "leaked": leaked,
           "launches": c_pf.counts}
    log(f"[{label}] a {n_ids}-token prompt: {len(frames)} frames ({meta['segments']} segments, "
        f"{meta['chain_tokens']} tokens), first frame at {frames[0][3] * 1e3:.1f} ms of the "
        f"export's {wall * 1e3:.1f} ms; adopt p50 {statistics.median(adopt_ms):.2f} ms a frame; "
        f"the parse cached {warm.cached_tokens} (cold {cold.cached_tokens}), "
        f"{'equal' if not diverged else 'parted'}; leaked {leaked}")
    del cold_eng
    _free_cuda()
    return row


FEED_TEXTS = ["search for wireless noise cancelling headphones under two hundred dollars",
              "open the second result and add it to the cart please",
              "sort these results by customer rating from high to low",
              "scroll down two pages and take a screenshot of the table"]


def _feeds(params, totals: dict) -> dict:
    """Each of 4 prompts fed as its growing word prefixes (``feed_prefix``),
    then the 4 parsed at once; against the same 4 parsed unfed on another
    engine: the tokens, the cached tokens and the admitting step."""
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.prompts import render_prompt

    fed_eng, cold_eng = _warm_engine(params), _warm_engine(params)
    prompts = [render_prompt(t, {}) for t in FEED_TEXTS]
    b = ContinuousBatcher(fed_eng, chunk_steps=16, max_new_tokens=HANDOFF_NEW_TOKENS)
    feeds = []
    with Counted("handoff feeds", totals):
        for text in FEED_TEXTS:
            words = text.split()
            for k in range(3, len(words), 3):
                feeds.append(b.feed_prefix(render_prompt(" ".join(words[:k]), {})))
    fail_if(not all(f["ok"] for f in feeds), f"feeds: a feed shed {feeds}")
    fed, fed_step, _ = _admitting_step(fed_eng, prompts, "handoff feeds parse", totals)
    unfed, unfed_step, _ = _admitting_step(cold_eng, prompts, "handoff unfed parse", totals)
    ids = [fed_eng.tokenizer.encode(p, bos=True) for p in prompts]
    diverged = _partings(cold_eng, ids, [r.token_ids for r in unfed], [r.token_ids for r in fed],
                         "feeds", "fed and unfed parses")
    _check_partings(diverged, "feeds", BF16_PART_ULPS)
    leaked = {"fed": _leaked(fed_eng), "unfed": _leaked(cold_eng)}
    fail_if(any(leaked.values()), f"feeds: leaked blocks {leaked}")
    row = {"feeds": len(feeds), "feed_cached_tokens": [f["cached_tokens"] for f in feeds],
           "cached_fed": [r.cached_tokens for r in fed],
           "cached_unfed": [r.cached_tokens for r in unfed],
           "admitting_stages_ms": {"fed": fed_step["stages"], "unfed": unfed_step["stages"]},
           "equal": len(prompts) - len(diverged), "partings": diverged, "leaked": leaked}
    log(f"[handoff feeds] {len(feeds)} feeds; cached fed {row['cached_fed']} unfed "
        f"{row['cached_unfed']}; the admitting step's prefill fed "
        f"{fed_step['stages']['prefill']:.2f} / unfed {unfed_step['stages']['prefill']:.2f} ms "
        f"(admit {fed_step['stages']['admit']:.2f} / {unfed_step['stages']['admit']:.2f}); "
        f"equal {row['equal']}/{len(prompts)}")
    del fed_eng, cold_eng
    _free_cuda()
    return row


class _LaunchLog:
    """A stand-in for the bound kernel library that records the thread,
    time and kernel of every kernel call before making it: what tells one
    thread's launches from another's (``ops`` keeps one process-wide
    counter a kernel). A wrapper that launches a kernel in parts calls it
    once a part."""

    def __init__(self, lib):
        self._lib = lib
        self.calls: list = []  # (thread, monotonic time, kernel)

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if not name.startswith("tva_"):
            return fn
        kernel = name[len("tva_"):]

        def launch(*a):
            self.calls.append((threading.current_thread(), time.monotonic(), kernel))
            return fn(*a)

        return launch

    def by_kernel(self, threads) -> dict:
        """Calls a kernel made from ``threads``."""
        out: dict = {}
        for t, _, k in list(self.calls):
            if t in threads:
                out[k] = out.get(k, 0) + 1
        return out


WATCHDOG_NEW_TOKENS = 160  # past one chunk's most (16 steps x (1 + ff 8)): no row ends in step 1


def _gated_posts(parser, url: str, bodies: list, pool) -> list:
    """POST ``bodies`` to /parse while the loop's thread is held in its call
    lane, and let it go once every parse waits in its inbox: the next step
    admits them together, as ``generate_many`` admits its prompts."""
    gate = threading.Event()
    parser.loop.submit_call(lambda: gate.wait(120))
    futs = [pool.submit(_post, url, body) for body in bodies]
    give_up = time.monotonic() + 120
    while len(parser.loop._inbox) < len(bodies) and time.monotonic() < give_up:
        time.sleep(0.005)
    fail_if(len(parser.loop._inbox) != len(bodies), "watchdog: the parses never queued together")
    gate.set()
    return futs


def _watchdog(params, totals: dict) -> dict:
    """The stalled-step drill on a 32-slot brain over HTTP:
    ``stall_step@2`` (the step after the 8 parses were admitted, so the
    stalled thread holds live rows), ``ENGINE_STALL_S`` above every healthy
    step (5 s, or 3x the slowest step of the fresh engine's run of the same
    32 prompts where that is more: a 32-slot admitting step is host-bound
    and its wall varies by host), ``CHAOS_STALL_S`` 3 s past it; then the
    next 32 parses through the same brain, token for token a fresh
    engine's."""
    import concurrent.futures

    from tpu_voice_agent_torch.ops import _lib
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.utils import chaos
    from tpu_voice_agent_torch.utils.steplog import get_steplog
    from tpu_voice_agent_torch.utils.tracing import get_flight_recorder, get_metrics

    def restarts():
        return get_metrics().snapshot()["counters"].get("engine.restarts", 0.0)

    def step_walls(seq0: int) -> list:
        """The walls (s) of the batcher steps the step ledger recorded since
        ``seq0``."""
        return [st["wall_ms"] / 1e3 for st in get_steplog().steps() if st["seq"] >= seq0]

    eng = _warm_engine(params)
    prompts = [_batch_prompt(i) for i in range(BATCH_SLOTS)]
    fresh_eng = _warm_engine(params)
    seq0 = get_steplog().dump()["recorded"]
    fresh = ContinuousBatcher(fresh_eng, chunk_steps=16,
                              max_new_tokens=WATCHDOG_NEW_TOKENS).generate_many(prompts)
    fresh_walls = step_walls(seq0)
    fail_if(not fresh_walls, "watchdog: the step ledger recorded none of the fresh run's steps")
    del fresh_eng
    stall_s = max(5, math.ceil(3 * max(fresh_walls)))
    chaos_s = stall_s + 3
    env = {"CHAOS_FAULTS": "stall_step@2", "CHAOS_STALL_S": str(chaos_s),
           "ENGINE_STALL_S": str(stall_s)}
    os.environ.update(env)
    chaos.configure("stall_step@2")
    get_flight_recorder().rearm()
    real_lib = _lib.library()
    spy = _LaunchLog(real_lib)
    _lib._LIB = spy
    forwards: list = []  # (thread, time) of every model forward on the engine
    forward = eng._forward

    def watched(*a, **kw):
        forwards.append((threading.current_thread(), time.monotonic()))
        return forward(*a, **kw)

    eng._forward = watched
    r0 = restarts()
    superseded: list = []
    decoded: dict = {}  # rendered prompt -> its GenerationResult, from the HTTP threads
    try:
        parser = brain.BatchedEngineParser(eng, max_new_tokens=WATCHDOG_NEW_TOKENS,
                                           session_aware=True)
        supersede, decode = parser.batcher.supersede, parser._decode

        def watched_supersede():
            superseded.append(time.monotonic())
            supersede()

        def recorded(prompt):
            res = decode(prompt)
            decoded[prompt] = res
            return res

        parser.batcher.supersede, parser._decode = watched_supersede, recorded
        old = parser.loop._thread
        srv, thread, url = _serve_brain(brain.BrainApp(parser))
        with concurrent.futures.ThreadPoolExecutor(BATCH_SLOTS) as pool:
            t0 = time.perf_counter()
            futs = _gated_posts(parser, url, [{"text": f"search for item {i}", "context": {}}
                                              for i in range(8)], pool)
            answers = [f.result() for f in futs]
            failed_s = time.perf_counter() - t0
            fail_if(restarts() - r0 != 1, f"watchdog: engine.restarts moved {restarts() - r0}")
            for status, body in answers:
                fail_if(status != 500 or body.get("detail") != STALL_TEXT,
                        f"watchdog: a stalled parse answered {status} {body}")
            dump = get_flight_recorder().frozen_dump()
            fail_if(dump is None or dump.get("reason") != "engine.stall",
                    f"watchdog: flight recorder {dump and dump.get('reason')}")
            chaos.reset()
            for k in env:
                os.environ.pop(k, None)
            old.join(chaos_s + 30)  # the stalled thread wakes from its sleep and exits
            fail_if(old.is_alive(), "watchdog: the stalled loop thread did not exit")
            # the next batch through the same brain, on the restarted loop
            with Counted("handoff watchdog next batch", totals) as c:
                seq1 = get_steplog().dump()["recorded"]
                t1 = time.perf_counter()
                futs = _gated_posts(parser, url, [
                    {"text": f"search for item {i} and sort by price", "context": {}}
                    for i in range(BATCH_SLOTS)], pool)
                statuses = [f.result()[0] for f in futs]
                next_s = time.perf_counter() - t1
                next_walls = step_walls(seq1)
            c.require("paged_block_attention", "masked_argmax_advance")
        _stop(srv, thread)
        restarted = parser.loop._thread is not old and parser.loop.healthy()
        parser.close()
    finally:
        _lib._LIB = real_lib
        eng._forward = forward
        chaos.reset()
        for k in env:
            os.environ.pop(k, None)
    fail_if(len(superseded) != 1,
            f"watchdog: {len(superseded)} supersedes (watchdog {stall_s} s; the fresh run's "
            f"steps {[round(w, 2) for w in fresh_walls]} s, the brain's since "
            f"{[round(w, 2) for w in step_walls(seq0 + len(fresh_walls))]} s)")
    t_sup = superseded[0]
    live = [at for t, at in forwards if t is old]
    stray = [at for t, at, _ in spy.calls if t is old and at > t_sup]
    stray_fwd = [at for at in live if at > t_sup]
    after = [at for t, at, _ in spy.calls if t is not old and at > t_sup]
    fail_if(not live, "watchdog: the stalled thread never ran a forward (no live rows)")
    fail_if(stray or stray_fwd, f"watchdog: {len(stray)} kernel launches and {len(stray_fwd)} "
                                "forwards from the stalled thread after the supersede")
    fail_if(not after or not restarted, "watchdog: the restarted loop served nothing")
    fail_if(sorted(decoded) != sorted(prompts),
            f"watchdog: {len(decoded)} of the next {BATCH_SLOTS} parses decoded")
    equal = sum(decoded[p].token_ids == f.token_ids for p, f in zip(prompts, fresh))
    fail_if(equal != BATCH_SLOTS, f"watchdog: the next batch equals a fresh engine's for "
                                  f"{equal}/{BATCH_SLOTS} requests")
    fail_if(_leaked(eng), "watchdog: leaked blocks after the next batch")
    row = {"failed_fast_s": failed_s, "answers": [s for s, _ in answers],
           "restarts": restarts() - r0, "forwards_before_stall": len(live),
           "launches_from_stalled_after": len(stray), "forwards_from_stalled_after":
           len(stray_fwd), "launches_after_restart": len(after), "next_batch_s": next_s,
           "next_batch_statuses": sorted(set(statuses)), "next_batch_equal": equal,
           "engine_stall_s": stall_s, "chaos_stall_s": chaos_s,
           "fresh_max_step_s": max(fresh_walls), "next_batch_max_step_s": max(next_walls)}
    log(f"[handoff watchdog] 8 live parses failed with JAX's text {failed_s:.2f} s after they "
        f"were sent (stall {chaos_s} s at step 2, watchdog {stall_s} s over a fresh run's "
        f"slowest step of {max(fresh_walls):.2f} s); engine.restarts +{row['restarts']}; "
        f"the stalled thread ran {len(live)} forwards before the supersede and {len(stray)} "
        f"launches after it; the next {BATCH_SLOTS} over HTTP in {next_s:.2f} s, equal to a "
        f"fresh engine's {equal}/{BATCH_SLOTS} (statuses {row['next_batch_statuses']}; "
        f"slowest step {max(next_walls):.2f} s)")
    del eng
    _free_cuda()
    return row


def _drain_drill(totals: dict) -> dict:
    """``POST /admin/drain`` on a batched brain (the distilled checkpoint on
    a 4-slot paged radix pool, so parses answer real intents) with 4 parses
    in flight, then one more after the drain began."""
    import concurrent.futures
    from dataclasses import replace

    from tpu_voice_agent_torch import distilled
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
    from tpu_voice_agent_torch.services import brain

    cfg, params = distilled.load_distilled()
    eng = PagedDecodeEngine(cfg=replace(cfg, max_seq_len=512), max_len=512,
                            prefill_buckets=(64, 128), init_weights=False, batch_slots=4,
                            block_size=16, radix_enable=True)
    eng.load_params(params)
    parser = brain.BatchedEngineParser(eng, max_new_tokens=300, session_aware=True,
                                       render=distilled.distilled_prompt)
    srv, thread, url = _serve_brain(brain.BrainApp(parser))
    recs = distilled.golden_records()[:5]

    def health():
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            return json.loads(r.read())

    try:
        with Counted("handoff drain", totals), concurrent.futures.ThreadPoolExecutor(5) as pool:
            futs = [pool.submit(_post, url, {"text": r["text"], "context": r["context"]})
                    for r in recs[:4]]
            while not parser.batcher.busy() and not all(f.done() for f in futs):
                time.sleep(0.001)
            d = json.loads(urllib.request.urlopen(urllib.request.Request(
                url + "/admin/drain", data=b"", method="POST"), timeout=60).read())
            h0 = health()
            late = pool.submit(_post, url, {"text": recs[4]["text"],
                                            "context": recs[4]["context"]})
            answers = [f.result() for f in futs] + [late.result()]
        give_up = time.monotonic() + 30
        while not health().get("drained") and time.monotonic() < give_up:
            time.sleep(0.05)
        h1 = health()
    finally:
        _stop(srv, thread)
        parser.close()
    fail_if(not (d["ok"] and d["draining"]), f"drain: {d}")
    fail_if(not h0.get("draining"), f"drain: /health after the drain {h0}")
    fail_if([s for s, _ in answers] != [200] * 5, f"drain: answers {[s for s, _ in answers]}")
    fail_if(not h1.get("drained"), f"drain: never drained {h1}")
    row = {"in_flight_at_drain": not h0.get("drained"), "answers": [s for s, _ in answers],
           "equal_to_recording": sum(b == r["response"] for (_, b), r in zip(answers, recs)),
           "health_after_drain": {k: h0.get(k) for k in ("draining", "drained")},
           "health_at_end": {k: h1.get(k) for k in ("draining", "drained")}}
    log(f"[handoff drain] 4 parses in flight + 1 after the drain: {row['answers']} "
        f"({row['equal_to_recording']}/5 equal to the JAX recording); /health "
        f"{row['health_after_drain']} at once, {row['health_at_end']} at the end")
    del eng
    _free_cuda()
    return row


def phase_handoff(params, totals: dict, report: dict) -> None:
    """The brain's warm state (``serve/handoff.py``, the batcher's feeds and
    exports, the serving loop's watchdog and drain latch, the
    ``/admin/*`` routes) at full width; see the module docstring, 11e."""
    import torch

    out = {}
    for tier in ("off", "int8", "int4"):
        out[tier] = _handoff_tier(params, tier, totals, BF16_PART_ULPS, f"handoff {tier}")
    out["disagg"] = _disagg(params, totals, BF16_PART_ULPS, "handoff disagg")
    out["feeds"] = _feeds(params, totals)
    out["watchdog"] = _watchdog(params, totals)
    out["drain"] = _drain_drill(totals)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p32 = _fp32_activations(params)
        out["off fp32"] = _handoff_tier(p32, "off", totals, 1, "handoff off fp32")
        out["disagg fp32"] = _disagg(p32, totals, 1, "handoff disagg fp32")
        del p32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    report["handoff"] = out


# ------------------------------------------------------------------ fleet

FLEET_SLOTS = 8  # BRAIN_BATCH of each fleet brain
# each fleet parse's budget: a random-weight answer ends at EOS in ~30
# tokens, a few run past 32 and would answer 422, recording no turn
FLEET_NEW_TOKENS = BATCH_NEW_TOKENS
FLEET_SESSIONS = 6  # a depth the script's time limit sets
FLEET_DEADLINE_MS = 120_000  # the x-deadline-ms every fleet parse carries
FLEET_INFLIGHT = 4  # parses in flight on the member the drain drill drains
FLEET_CRASH_PARSES = 8
FLEET_FP32_SESSIONS = 4
FLEET_GRAY_TEXT = "scroll down"  # one prompt for every gray window: equal walls but the chaos
# CHAOS_SLOW_S of the gray drill's degraded member. The drill's router runs
# at the default FLEET_GRAY_MAD (4): of three members the MAD is the gap
# between the two healthy ones' forward walls, up to ~165 ms late in the
# full script, so a forward 3 s slower scores past 4 while that gap stays
# under ~500 ms
FLEET_SLOW_S = "3.0"
# the JAX defaults the phase lifts or reads against (SLO_TARGET_P50_MS, its
# p99 4x, ROUTER_SHED_PRESSURE)
DEFAULT_SLO_P50_MS = 800.0
DEFAULT_SHED_PRESSURE = 0.9
# the fleet kernels whose calls each brain's serving thread makes (K1, K3,
# K4, K6, K7)
FLEET_KERNELS = ("flash_attention", "decode_block_attention_layer", "masked_argmax_advance",
                 "paged_attention", "paged_block_attention")


class _FleetBrain:
    """One brain of the fleet phase: a paged radix engine on the shared
    weights (BRAIN_BATCH=8 BRAIN_PAGED=1 RADIX_ENABLE=1, the cached
    prefix), its session-aware parser with every decode logged as (prompt,
    result), and its ``BrainApp`` on a port of its own. ``restart`` is a
    fresh process on the same engine and port (the engine warm-restarted:
    the tree and the transcripts are gone, as after a real restart)."""

    def __init__(self, name: str, params, port: int = 0):
        from tpu_voice_agent_torch.services.brain import install_prompt_prefix

        self.name = name
        self.eng = _paged_engine(params, 8, batch_slots=FLEET_SLOTS, radix_enable=True,
                                 prefill_buckets=RADIX_BUCKETS)
        install_prompt_prefix(self.eng)
        self.decodes: list = []
        self.threads: set = set()  # every serving thread this brain ever ran
        self._boot(port)

    def _boot(self, port: int) -> None:
        from tpu_voice_agent_torch.services import brain

        self.parser = brain.BatchedEngineParser(self.eng, max_new_tokens=FLEET_NEW_TOKENS,
                                                session_aware=True)
        inner = self.parser._decode

        def logged(prompt):
            res = inner(prompt)
            self.decodes.append((prompt, res))
            return res

        self.parser._decode = logged
        self.app = brain.BrainApp(self.parser)
        self.srv, self.thread, self.url = _serve(brain.make_server(self.app, port=port))
        self.threads.add(self.parser.loop._thread)

    def loop_threads(self) -> set:
        t = self.parser.loop._thread
        if t is not None:
            self.threads.add(t)
        return self.threads

    def stop(self) -> None:
        self.loop_threads()
        _stop(self.srv, self.thread)
        self.app.close()
        self.parser.close()

    def restart(self) -> None:
        port = self.srv.server_address[1]
        self.stop()
        self.eng.warm_restart()
        self._boot(port)

    def result_for(self, prompt):
        """The logged decode of ``prompt`` (the last one)."""
        for p, res in reversed(self.decodes):
            if p == prompt:
                return res
        return None


def _fleet_counters() -> dict:
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    c = get_metrics().snapshot()["counters"]
    return {k: v for k, v in c.items() if k.startswith(("router.", "fleet.", "disagg.",
                                                         "autopilot."))}


def _fleet_delta(c0: dict) -> dict:
    return {k: v - c0.get(k, 0.0) for k, v in _fleet_counters().items() if v != c0.get(k, 0.0)}


def _fleet_parse(url: str, sid: str | None, text: str, ctx: dict):
    """One /parse through ``url`` with the fleet deadline: (status, response
    headers, body, wall s)."""
    headers: dict = {}
    body = {"text": text, "context": ctx}
    if sid is not None:
        body["session_id"] = sid
    t0 = time.perf_counter()
    status, out = _post(url, body, headers, send={"x-deadline-ms": str(FLEET_DEADLINE_MS)})
    return status, {k.lower(): v for k, v in headers.items()}, out, time.perf_counter() - t0


def _homed_on(urls: list, url: str, prefix: str, n: int = 1) -> list:
    """``n`` session ids whose rendezvous home over ``urls`` is ``url``."""
    from tpu_voice_agent_torch.services.replicaset import rendezvous_weight

    out, i = [], 0
    while len(out) < n:
        sid = f"{prefix}{i}"
        if max(urls, key=lambda u: rendezvous_weight(u, sid)) == url:
            out.append(sid)
        i += 1
    return out


def _prompt_ids(eng, prompts: list) -> list:
    return [eng.tokenizer.encode(p, bos=True) if isinstance(p, str) else list(p) for p in prompts]


def _default_slo_reading(b) -> dict:
    """What ``b``'s ``/health`` pressure would read at the default SLO
    targets (800 ms p50, 3,200 ms p99) over the same parse walls: a
    passive tracker over a copy of its SLO samples; ``shed`` is whether
    that score reaches the default ``ROUTER_SHED_PRESSURE``."""
    from tpu_voice_agent_torch.services.slo import SLOTracker

    t = SLOTracker("brain", target_p50_ms=DEFAULT_SLO_P50_MS,
                   target_p99_ms=4 * DEFAULT_SLO_P50_MS, passive=True)
    with b.app.slo._lock:
        t._samples.extend(b.app.slo._samples)
    ev = t.evaluate()
    score = b.app.pressure(ev["state"])["score"]
    return {"slo": ev["state"], "samples": ev["samples"], "p50_ms": ev["p50_ms"],
            "p99_ms": ev["p99_ms"], "pressure": score, "shed": score >= DEFAULT_SHED_PRESSURE}


def _fleet_affinity(brains: list, router, totals: dict, pool) -> dict:
    """6 sessions x 2 turns through the router, each turn's 6 at once:
    every answer 200 on the session's rendezvous home, turn 2 reading
    cached tokens past the prefix."""
    from tpu_voice_agent_torch.services.replicaset import rendezvous_weight

    urls = [b.url for b in brains]
    P = len(brains[0].eng.prefix_ids)
    sids = [f"fleet-{i}" for i in range(FLEET_SESSIONS)]
    homes = {sid: max(urls, key=lambda u: rendezvous_weight(u, sid)) for sid in sids}
    turns = []
    with Counted("fleet affinity", totals) as c:
        for text, ctx in HANDOFF_TURNS:
            futs = {sid: pool.submit(_fleet_parse, router.url, sid, f"{text} ({sid})", ctx)
                    for sid in sids}
            turns.append({sid: f.result() for sid, f in futs.items()})
    c.require("paged_block_attention", "masked_argmax_advance")
    for t, answers in enumerate(turns):
        for sid, (st, h, body, _) in answers.items():
            fail_if(st != 200, f"fleet affinity: {sid} turn {t + 1}: {st} {body}")
            fail_if(h.get("x-router-replica") != homes[sid],
                    f"fleet affinity: {sid} turn {t + 1} served by {h.get('x-router-replica')}, "
                    f"its home is {homes[sid]}")
    cached2 = {sid: int(turns[1][sid][1].get("x-cached-tokens", 0)) for sid in sids}
    fail_if(min(cached2.values()) <= P,
            f"fleet affinity: turn 2 cached {sorted(cached2.values())}, prefix {P}")
    per_home = {b.name: sum(homes[s] == b.url for s in sids) for b in brains}
    slo = {b.name: _default_slo_reading(b) for b in brains}
    tokens = sorted(r.steps for b in brains for _, r in b.decodes)
    walls = [sorted(round(a[3], 2) for a in answers.values()) for answers in turns]
    row = {"sessions": FLEET_SESSIONS, "per_home": per_home, "prefix_tokens": P,
           "turn2_cached_tokens": sorted(cached2.values()),
           "turn_walls_s": [max(a[3] for a in answers.values()) for answers in turns],
           "parse_walls_s": walls, "decode_tokens": tokens, "default_slo": slo,
           "launches": c.counts}
    log(f"[fleet affinity] {FLEET_SESSIONS} sessions x 2 turns, homes {per_home} = rendezvous; "
        f"turn 2 cached {min(cached2.values())}-{max(cached2.values())} tokens (prefix {P}); "
        f"parse walls by turn {walls} s; decode tokens {tokens}")
    log(f"[fleet affinity] at the default SLO: {json.dumps(slo)}")
    return {"row": row, "homes": homes}


def _fleet_rehome(brains: list, router, totals: dict, pool, ulps: float, label: str,
                  sids: list) -> dict:
    """Drain ``brains[0]`` through the router with ``FLEET_INFLIGHT`` parses
    in flight on it (each answers 200), take the stay-home turn 3 of its
    sessions ``sids`` on it, then turn 3 through the router: each re-homes
    warm and equals the stay-home turn (or parts at a near tie within
    ``ulps``)."""
    text3, ctx3 = HANDOFF_TURN3
    home = brains[0]
    urls = [b.url for b in brains]
    P = len(home.eng.prefix_ids)
    inflight = _homed_on(urls, home.url, f"{label}-inflight-", FLEET_INFLIGHT)
    futs = [pool.submit(_fleet_parse, router.url, sid, f"{HANDOFF_TURNS[0][0]} ({sid})", {})
            for sid in inflight]
    give_up = time.monotonic() + 120
    while (router.member(home.url).inflight < FLEET_INFLIGHT and not all(f.done() for f in futs)
           and time.monotonic() < give_up):
        time.sleep(0.002)
    busy_at_drain = router.member(home.url).inflight
    req = urllib.request.Request(router.url + "/admin/drain", method="POST",
                                 data=json.dumps({"replica": home.url}).encode())
    with urllib.request.urlopen(req, timeout=60) as r:
        ack = json.loads(r.read())
    answers = [f.result() for f in futs]
    fail_if(busy_at_drain == 0 or ack.get("state") != "draining",
            f"{label}: the drain found {busy_at_drain} in flight ({ack})")
    fail_if([a[0] for a in answers] != [200] * FLEET_INFLIGHT,
            f"{label}: in-flight answers {[a[0] for a in answers]}")
    fail_if(sum(a[1].get("x-router-replica") == home.url for a in answers) < busy_at_drain,
            f"{label}: a parse in flight at the drain left its draining home")
    fail_if(router.member(home.url).state != "drained",
            f"{label}: {router.member(home.url).state} after the last in-flight answer")
    prompts = [home.parser.transcripts.prompt_for(sid, f"{text3} ({sid})", ctx3) for sid in sids]
    with Counted(f"{label} stay-home turn 3", totals):
        stay = [f.result(timeout=600) for f in [home.parser.loop.submit(p) for p in prompts]]
    fail_if(any(r.error for r in stay), f"{label}: stay-home {[r.error for r in stay]}")
    c0 = _fleet_counters()
    with Counted(f"{label} re-homed turn 3", totals) as c:
        moved_ans = [f.result() for f in [pool.submit(_fleet_parse, router.url, sid,
                                                      f"{text3} ({sid})", ctx3) for sid in sids]]
    c.require("paged_block_attention", "masked_argmax_advance")
    d = _fleet_delta(c0)
    fail_if([a[0] for a in moved_ans] != [200] * len(sids),
            f"{label}: turn 3 answers {[a[0] for a in moved_ans]}")
    fail_if(d.get("router.sessions_rehomed_warm", 0) != len(sids)
            or d.get("router.sessions_rehomed_cold", 0) != 0, f"{label}: counters {d}")
    moved = []
    for sid, p, (st, h, body, _) in zip(sids, prompts, moved_ans):
        served = next(b for b in brains if b.url == h.get("x-router-replica"))
        fail_if(served is home, f"{label}: {sid} stayed on its drained home")
        res = served.result_for(p)
        fail_if(res is None, f"{label}: {sid}'s turn 3 on {served.name} renders another prompt")
        moved.append(res)
    fail_if(any(int(a[1].get("x-cached-tokens", 0)) <= P for a in moved_ans),
            f"{label}: a re-homed turn 3 read no warm span past the prefix")
    diverged = _partings(home.eng, _prompt_ids(home.eng, prompts), [r.token_ids for r in stay],
                         [r.token_ids for r in moved], label, "stay-home and re-homed turn 3")
    _check_partings(diverged, label, ulps)
    row = {"sessions": len(sids), "in_flight_at_drain": busy_at_drain,
           "in_flight_answers": [a[0] for a in answers],
           "turn3_cached_moved": [r.cached_tokens for r in moved],
           "turn3_cached_stay": [r.cached_tokens for r in stay],
           "equal": len(sids) - len(diverged), "partings": diverged, "counters": d,
           "turn3_wall_s": max(a[3] for a in moved_ans)}
    log(f"[{label}] drain with {busy_at_drain} in flight: {row['in_flight_answers']}; "
        f"{len(sids)} sessions re-homed warm, turn 3 equal {row['equal']}/{len(sids)}, cached "
        f"{sorted(set(row['turn3_cached_moved']))} (stay {sorted(set(row['turn3_cached_stay']))}); "
        f"counters {d}")
    return row


def _fleet_fp32(params, totals: dict, pool) -> dict:
    """The warm re-home gate on fp32 activations, a two-member ring: two
    turns of ``FLEET_FP32_SESSIONS`` sessions on one member, its drain,
    turn 3 re-homed, held at one ulp."""
    import torch

    from tpu_voice_agent_torch.services.router import RouterThread

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    p32 = _fp32_activations(params)
    brains = [_FleetBrain(f"fp32-{i}", p32) for i in range(2)]
    router = RouterThread([b.url for b in brains], handoff_enable=True, fleet_detect=False)
    try:
        urls = [b.url for b in brains]
        sids = _homed_on(urls, brains[0].url, "fleet-fp32-", FLEET_FP32_SESSIONS)
        for text, ctx in HANDOFF_TURNS:
            answers = [f.result() for f in [pool.submit(_fleet_parse, router.url, sid,
                                                        f"{text} ({sid})", ctx) for sid in sids]]
            fail_if([a[0] for a in answers] != [200] * len(sids),
                    f"fleet fp32: turn answers {[a[0] for a in answers]}")
        return _fleet_rehome(brains, router, totals, pool, 1, "fleet fp32", sids)
    finally:
        router.close()
        for b in brains:
            b.stop()
        del brains, p32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        _free_cuda()


def _fleet_crash(brains: list, router, totals: dict, pool) -> dict:
    """``replica_kill@1`` on ``brains[1]`` as 8 parses homed on it arrive:
    all 8 answer 200 inside their deadline through the retry, the moves
    count cold, and two probe sweeps eject the member."""
    from tpu_voice_agent_torch.utils import chaos

    target = brains[1]
    urls = [b.url for b in brains]
    sids = _homed_on(urls, target.url, "fleet-crash-", FLEET_CRASH_PARSES)
    c0 = _fleet_counters()
    chaos.configure("replica_kill@1", seed=0)
    try:
        with Counted("fleet crash", totals):
            answers = [f.result() for f in [pool.submit(_fleet_parse, router.url, sid,
                                                        f"{HANDOFF_TURNS[0][0]} ({sid})", {})
                                            for sid in sids]]
        fail_if(not target.app._dead, "fleet crash: the kill never fired on its member")
        router.probe(router.robj.probe_fails_limit)
    finally:
        chaos.reset()
    d = _fleet_delta(c0)
    fail_if([a[0] for a in answers] != [200] * FLEET_CRASH_PARSES,
            f"fleet crash: answers {[a[0] for a in answers]}")
    fail_if(max(a[3] for a in answers) * 1e3 >= FLEET_DEADLINE_MS,
            "fleet crash: an answer came past its deadline")
    fail_if(d.get("router.retries", 0) < 1 or d.get("router.sessions_rehomed_cold", 0) < 1,
            f"fleet crash: counters {d}")
    fail_if(router.member(target.url).state != "down" or d.get("router.replicas_ejected") != 1,
            f"fleet crash: the prober left the member {router.member(target.url).state}")
    row = {"parses": FLEET_CRASH_PARSES, "answers": [a[0] for a in answers],
           "served_by": sorted({a[1].get("x-router-replica") for a in answers}),
           "max_wall_s": max(a[3] for a in answers), "deadline_ms": FLEET_DEADLINE_MS,
           "counters": d}
    log(f"[fleet crash] {FLEET_CRASH_PARSES} parses to {target.name} as it dies: "
        f"{row['answers']} (max wall {row['max_wall_s']:.2f} s of {FLEET_DEADLINE_MS} ms), "
        f"served by {len(row['served_by'])} other member(s); ejected after "
        f"{router.robj.probe_fails_limit} sweeps; counters {d}")
    return row


def _fleet_gray(brains: list, totals: dict) -> dict:
    """A fresh router over the three brains (no streak carried from the
    earlier drills), one sticky session placed on ``brains[2]``, then
    ``replica_degrade@1`` latches that member slow (``CHAOS_SLOW_S``): one
    identical parse a member a window (the victim's first), the three
    rings sampled back to back, then a probe sweep and its
    ``/debug/timeseries`` scrape. The victim is gray within
    ``FLEET_GRAY_WINDOWS`` windows, on the router-observed ``fwd_ms``; a new
    session homed on it goes elsewhere, the sticky one stays. (In one
    process the rings share the global registry: sampled at their own
    instants, its global series, the decode step histogram and the SLO
    p99 gauge, would differ between the members by the sampling window
    alone, which no separate processes would show.)"""

    def window() -> None:
        for b in brains:
            b.app.ring.sample_once()
        router.probe()

    from tpu_voice_agent_torch.services.router import RouterThread
    from tpu_voice_agent_torch.utils import chaos
    from tpu_voice_agent_torch.utils.tracing import get_flight_recorder

    victim = brains[2]
    order = [victim] + [b for b in brains if b is not victim]
    urls = [b.url for b in brains]
    router = RouterThread(urls)
    gray_mad = router.robj.gray_mad
    fail_if(gray_mad != 4.0, f"fleet gray: the router's FLEET_GRAY_MAD is {gray_mad}, not 4")
    windows = router.robj.gray_windows
    (sticky,) = _homed_on(urls, victim.url, "fleet-gray-sticky-")
    trace = []
    try:
        st, h, _, _ = _fleet_parse(router.url, sticky, f"{HANDOFF_TURNS[0][0]} ({sticky})", {})
        fail_if(st != 200 or h.get("x-router-replica") != victim.url,
                f"fleet gray: the sticky session's first turn {st} went to "
                f"{h.get('x-router-replica')}")
        for b in order[1:]:  # the sticky turn's twin on its peers: equal work a member
            (sid,) = _homed_on(urls, b.url, f"fleet-gray-first-{b.name}-")
            fail_if(_fleet_parse(router.url, sid, f"{HANDOFF_TURNS[0][0]} ({sid})", {})[0]
                    != 200, "fleet gray: a warm-up parse failed")
        for b in order:  # every member serves the drill's prompt once before it
            (sid,) = _homed_on(urls, b.url, f"fleet-gray-warm-{b.name}-")
            fail_if(_fleet_parse(router.url, sid, FLEET_GRAY_TEXT, {})[0] != 200,
                    "fleet gray: a warm-up parse failed")
        # a window of its own: these forwards are no drill reading, but the
        # healthy fleet's scores at the default MAD (a streak may start here)
        window()
        baseline = [(m.url == victim.url, m.gray, m.outlier_signal, round(m.outlier_score, 2))
                    for m in router.robj.replicas]
        streak0 = router.member(victim.url).gray_streak
        get_flight_recorder().rearm()
        c0 = _fleet_counters()
        os.environ["CHAOS_SLOW_S"] = FLEET_SLOW_S
        chaos.configure("replica_degrade@1", seed=0)
        with Counted("fleet gray", totals):
            for w in range(windows + 2):
                for b in order:
                    (sid,) = _homed_on(urls, b.url, f"fleet-gray-{w}-{b.name}-")
                    st, h, body, wall = _fleet_parse(router.url, sid, FLEET_GRAY_TEXT, {})
                    fail_if(st != 200, f"fleet gray: {st} {body}")
                window()
                trace.append([(m.url == victim.url, m.gray, m.outlier_signal,
                               round(m.outlier_score, 2)) for m in router.robj.replicas])
                if any(m.gray for m in router.robj.replicas):
                    break
            fail_if(not victim.app._slow, "fleet gray: the degrade never latched its member")
            gray = [m.url for m in router.robj.replicas if m.gray]
            fail_if(gray != [victim.url], f"fleet gray: gray {gray}, victim {victim.url}: {trace}")
            fail_if(len(trace) > windows,
                    f"fleet gray: {len(trace)} windows, limit {windows}: {trace}")
            (fresh,) = _homed_on(urls, victim.url, "fleet-gray-new-")
            st, h, _, _ = _fleet_parse(router.url, fresh, FLEET_GRAY_TEXT, {})
            fail_if(st != 200 or h.get("x-router-replica") == victim.url,
                    f"fleet gray: a new session went to the gray member ({st})")
            st, h, _, _ = _fleet_parse(router.url, sticky, f"{HANDOFF_TURNS[1][0]} ({sticky})",
                                       HANDOFF_TURNS[1][1])
            fail_if(st != 200 or h.get("x-router-replica") != victim.url,
                    f"fleet gray: the sticky session left its gray home ({st})")
        d = _fleet_delta(c0)
    finally:
        chaos.reset()
        os.environ.pop("CHAOS_SLOW_S", None)
        router.close()
    fail_if(d.get("fleet.gray_entered") != 1 or d.get("fleet.shed_gray", 0) < 1,
            f"fleet gray: counters {d}")
    dump = get_flight_recorder().state("router")
    ev = (dump.get("extra") or {}).get("fleet") or {}
    fail_if(not dump.get("frozen") or dump.get("reason") != "fleet.gray"
            or ev.get("replica") != victim.url, f"fleet gray: the dump {dump.get('reason')}")
    get_flight_recorder().rearm()
    healthy = [score for w in trace for is_victim, _, _, score in w if not is_victim]
    slo = {b.name: _default_slo_reading(b) for b in brains}
    row = {"windows": len(trace), "limit": windows, "gray_mad": gray_mad,
           "slow_s": float(FLEET_SLOW_S), "signal": ev.get("signal"), "score": ev.get("score"),
           "value": ev.get("value"), "fleet_median": ev.get("fleet_median"),
           "mad": ev.get("mad"), "trace": trace, "baseline": baseline,
           "victim_streak_before_chaos": streak0, "healthy_scores": healthy,
           "healthy_over_mad": sum(x > gray_mad for x in healthy), "default_slo": slo,
           "counters": d}
    log(f"[fleet gray] {victim.name} gray after {len(trace)} window(s) (limit {windows}) on "
        f"{ev.get('signal')}: {ev.get('value')} ms against the median {ev.get('fleet_median')} "
        f"(MAD {ev.get('mad')}, score {ev.get('score')}, threshold {gray_mad}); healthy "
        f"members' scores {healthy}; before the chaos (all healthy) {baseline}, the "
        f"victim's streak {streak0}; a new session placed elsewhere, the sticky one kept; "
        f"counters {d}")
    log(f"[fleet gray] at the default SLO: {json.dumps(slo)}")
    return row


def _fleet_disagg(brains: list, params, totals: dict, ulps: float) -> dict:
    """``ROUTER_DISAGG=1`` over ``brains[0]`` and ``brains[1]#prefill``: a
    prompt of ~1,000 tokens past the prefix is exported on the prefill
    member and pumped into the decode home; the home's parse is warm and
    equals a cold engine's."""
    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher
    from tpu_voice_agent_torch.services.prompts import render_prompt
    from tpu_voice_agent_torch.services.router import RouterThread

    dec, pf = brains[0], brains[1]
    router = RouterThread([dec.url, pf.url + "#prefill"], disagg=True, fleet_detect=False)
    prompt_text = render_prompt(DISAGG_TEXT, DISAGG_CONTEXT)
    n_ids = len(dec.eng.tokenizer.encode(prompt_text, bos=True))
    P = len(dec.eng.prefix_ids)
    try:
        c0 = _fleet_counters()
        n0 = len(dec.decodes)
        with Counted("fleet disagg", totals) as c:
            st, h, body, wall = _fleet_parse(router.url, "fleet-disagg", DISAGG_TEXT,
                                             DISAGG_CONTEXT)
        c.require("paged_block_attention", "masked_argmax_advance")
        d = _fleet_delta(c0)
    finally:
        router.close()
    fail_if(st != 200 or h.get("x-router-replica") != dec.url,
            f"fleet disagg: {st} from {h.get('x-router-replica')}")
    fail_if(d.get("disagg.admissions") != 1 or d.get("disagg.fallbacks", 0) != 0
            or d.get("disagg.frames_streamed", 0) < 2, f"fleet disagg: counters {d}")
    fail_if(len(dec.decodes) != n0 + 1, "fleet disagg: the home decoded another number of times")
    prompt, warm = dec.decodes[-1]
    fail_if(warm.error is not None or warm.cached_tokens < P + 512,
            f"fleet disagg: the home's parse cached {warm.cached_tokens} ({warm.error})")
    cold_eng = _warm_engine(params)
    cold = ContinuousBatcher(cold_eng, chunk_steps=16,
                             max_new_tokens=FLEET_NEW_TOKENS).generate_many([prompt])[0]
    diverged = _partings(cold_eng, _prompt_ids(cold_eng, [prompt]), [cold.token_ids],
                         [warm.token_ids], "fleet disagg", "the warm and the cold parse")
    _check_partings(diverged, "fleet disagg", ulps)
    del cold_eng
    _free_cuda()
    row = {"prompt_tokens": n_ids, "warm_cached_tokens": warm.cached_tokens,
           "cold_cached_tokens": cold.cached_tokens, "equal": not diverged,
           "partings": diverged, "wall_s": wall, "counters": d}
    log(f"[fleet disagg] a {n_ids}-token prompt: exported on {pf.name}, "
        f"{d.get('disagg.frames_streamed', 0):.0f} frames into {dec.name}, its parse cached "
        f"{warm.cached_tokens} (cold {cold.cached_tokens}), "
        f"{'equal' if not diverged else 'parted'}; wall {wall:.2f} s; counters {d}")
    return row


class _FleetSpawner:
    """The autopilot's spawner over in-process port brains on the shared
    weights: ``spawn`` boots a ``_FleetBrain`` off the event loop,
    ``retire`` stops one (its blocks past the tree's counted first)."""

    def __init__(self, params, known: dict):
        self.params = params
        self.brains = dict(known)  # url -> _FleetBrain, the seeds included
        self.spawned: list = []
        self.leaked: dict = {}

    def _boot(self) -> str:
        b = _FleetBrain(f"spawn-{len(self.spawned)}", self.params)
        self.brains[b.url] = b
        self.spawned.append(b)
        return b.url

    async def spawn(self) -> str:
        return await asyncio.get_running_loop().run_in_executor(None, self._boot)

    def _stop(self, url: str) -> None:
        b = self.brains.pop(url)
        self.leaked[url] = _leaked(b.eng)
        b.stop()

    async def retire(self, url: str) -> None:
        if url in self.brains:
            await asyncio.get_running_loop().run_in_executor(None, self._stop, url)


def _fleet_autopilot(seed, params, totals: dict, pool) -> dict:
    """``tick_once`` over a one-member ring: a scale-up (spawn -> pre-warm
    through the handoff wire -> admit) and a scale-down with parses in
    flight on both members (each answers 200; the retired brain's blocks
    are back to its tree's when it stops)."""
    from tpu_voice_agent_torch.services.autopilot import AutopilotController
    from tpu_voice_agent_torch.services.router import RouterThread

    router = RouterThread([seed.url], handoff_enable=True, fleet_detect=False)
    spawner = _FleetSpawner(params, {seed.url: seed})
    P = len(seed.eng.prefix_ids)
    # the band never commits by itself here (100 windows): the drill sets
    # the target and the reconcile follows it
    ap = AutopilotController(router.robj, spawner, min_replicas=1, max_replicas=2,
                             interval_s=1.0, target_util=0.6, up_windows=100, down_windows=100,
                             cooldown_s=0.0, join_timeout_s=120.0, forecast_lead_s=5.0)
    def tick() -> dict:
        # the rings sample when the drill says (TS_INTERVAL_S): a fresh
        # window each tick, or the controller holds as starved
        for b in list(spawner.brains.values()):
            b.app.ring.sample_once()
        return router.on_loop(ap.tick_once())

    try:
        st, _, body, _ = _fleet_parse(router.url, "fleet-ap-0",
                                      f"{HANDOFF_TURNS[0][0]} (fleet-ap-0)", {})
        fail_if(st != 200, f"fleet autopilot: the donor session's parse {st} {body}")
        c0 = _fleet_counters()
        ap.target = 2
        t0 = time.perf_counter()
        with Counted("fleet autopilot up", totals):
            up = tick()
        up_s = time.perf_counter() - t0
        join = [x for x in ap.decisions if x["action"] == "join"]
        fail_if(up["brain"]["actual"] != 2 or not join or join[-1]["reason"] != "prewarmed"
                or join[-1]["adopted_tokens"] <= P, f"fleet autopilot: the join {join}")
        (new,) = spawner.spawned
        futs = []
        for b in (seed, new):
            for sid in _homed_on([seed.url, new.url], b.url, f"fleet-ap-{b.name}-", 3):
                futs.append(pool.submit(_fleet_parse, router.url, sid,
                                        f"{HANDOFF_TURNS[0][0]} ({sid})", {}))
        give_up = time.monotonic() + 120
        while sum(m.inflight for m in router.robj.replicas) == 0 and time.monotonic() < give_up:
            time.sleep(0.002)
        ap.target = 1
        t0 = time.perf_counter()
        with Counted("fleet autopilot down", totals):
            tick()
            answers = [f.result() for f in futs]
            for _ in range(20):
                if len(router.robj.replicas) == 1:
                    break
                time.sleep(0.05)
                tick()
        down_s = time.perf_counter() - t0
        d = _fleet_delta(c0)
    finally:
        router.close()
    fail_if([a[0] for a in answers] != [200] * len(answers),
            f"fleet autopilot: in-flight answers {[a[0] for a in answers]}")
    fail_if(len(router.robj.replicas) != 1 or len(spawner.leaked) != 1,
            f"fleet autopilot: {len(router.robj.replicas)} members, retired {spawner.leaked}")
    (gone, leaked), = spawner.leaked.items()
    fail_if(leaked != 0, f"fleet autopilot: the retired brain held {leaked} blocks past its tree")
    fail_if(d.get("autopilot.joins_prewarmed") != 1 or d.get("autopilot.retired") != 1
            or d.get("autopilot.holds_starved"), f"fleet autopilot: counters {d}")
    row = {"join": join[-1], "scale_up_s": up_s, "scale_down_s": down_s,
           "in_flight_answers": [a[0] for a in answers], "retired": gone,
           "retired_leaked_blocks": leaked, "counters": d,
           "decisions": [(x["action"], x["reason"]) for x in ap.decisions]}
    log(f"[fleet autopilot] scale-up {up_s:.2f} s (joined pre-warmed, "
        f"{join[-1]['adopted_tokens']} tokens adopted); scale-down {down_s:.2f} s with "
        f"{len(answers)} parses in flight: {row['in_flight_answers']}, retired "
        f"{'the spawned' if gone == new.url else 'the seed'} brain with {leaked} blocks past its "
        f"tree; counters {d}")
    return {"row": row, "spawned": spawner.spawned}


def phase_fleet(params, totals: dict, report: dict) -> None:
    """The fleet (``services/router.py``, ``replicaset.py``,
    ``autopilot.py``, the brains' ``/debug/timeseries``) at full width:
    three port brains on one weight set behind the port's router; see the
    module docstring, 11f. Each drill's wall, the router's counters and
    each brain's kernel calls (by its serving threads) are printed."""
    import concurrent.futures

    from tpu_voice_agent_torch.ops import _lib
    from tpu_voice_agent_torch.services.router import RouterThread

    out: dict = {}
    walls: dict = {}
    real_lib = _lib.library()
    spy = _LaunchLog(real_lib)
    _lib._LIB = spy
    # the SLO targets lifted for the phase: at the default 800 ms p50 a
    # full-width parse beside two other brains on the card reads as a
    # violated SLO, whose pressure score (1.0) sheds new sessions off a
    # member that reads it before its peers do (all of them at once falls
    # back to rendezvous); the drills check placement, the gray drill the
    # detector's demotion (and only it freezes the flight recorder), and
    # ``_default_slo_reading`` prints what the defaults would read. The
    # brains' time-series rings sample when the gray drill says
    # (TS_INTERVAL_S: no sampler tick inside the phase)
    slo_env = {k: os.environ.get(k) for k in ("SLO_TARGET_P50_MS", "SLO_TARGET_P99_MS",
                                                "TS_INTERVAL_S")}
    os.environ.update(SLO_TARGET_P50_MS="600000", SLO_TARGET_P99_MS="600000",
                      TS_INTERVAL_S="3600")
    brains = []
    router = None
    extra: list = []
    try:
        t0 = time.perf_counter()
        brains = [_FleetBrain(name, params) for name in ("a", "b", "c")]
        router = RouterThread([b.url for b in brains], handoff_enable=True, fleet_detect=False)
        walls["boot"] = time.perf_counter() - t0
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            t0 = time.perf_counter()
            aff = _fleet_affinity(brains, router, totals, pool)
            out["affinity"] = aff["row"]
            walls["affinity"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            # the drill drains the member with the most sessions
            home = max(brains, key=lambda b: sum(u == b.url for u in aff["homes"].values()))
            drained = [sid for sid, u in aff["homes"].items() if u == home.url]
            out["drain"] = _fleet_rehome([home] + [b for b in brains if b is not home], router,
                                         totals, pool, BF16_PART_ULPS, "fleet drain", drained)
            router.probe()  # the prober reads the drained member's latch
            home.restart()  # its rolling restart: the latch is gone
            router.probe()
            fail_if(router.member(home.url).state != "up",
                    "fleet: the restarted member never rejoined")
            walls["drain"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["drain_fp32"] = _fleet_fp32(params, totals, pool)
            walls["drain_fp32"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["crash"] = _fleet_crash(brains, router, totals, pool)
            brains[1].restart()
            router.probe()
            fail_if(router.member(brains[1].url).state != "up",
                    "fleet: the crashed member's restart never rejoined")
            out["router_counters"] = _fleet_counters()
            router.close()
            router = None
            walls["crash"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["gray"] = _fleet_gray(brains, totals)
            walls["gray"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["disagg"] = _fleet_disagg(brains, params, totals, BF16_PART_ULPS)
            walls["disagg"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            ap = _fleet_autopilot(brains[0], params, totals, pool)
            out["autopilot"] = ap["row"]
            extra = [b for b in ap["spawned"]]
            walls["autopilot"] = time.perf_counter() - t0
    finally:
        if router is not None:
            router.close()
        for b in brains + extra:
            try:
                b.stop()
            except Exception:  # noqa: BLE001 - one already stopped by its retire
                pass
        _lib._LIB = real_lib
        for k, v in slo_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    per_brain = {}
    for b in brains + extra:
        calls = spy.by_kernel(b.loop_threads())
        per_brain[b.name] = {k: calls.get(k, 0) for k in FLEET_KERNELS}
    for name, calls in per_brain.items():
        fail_if(calls["paged_block_attention"] <= 0 or calls["masked_argmax_advance"] <= 0,
                f"fleet: brain {name}'s serving threads made no K7 / K4 call {calls}")
    out["walls_s"] = walls
    out["kernel_calls_by_brain"] = per_brain
    log(f"[fleet] walls {json.dumps({k: round(v, 2) for k, v in walls.items()})}")
    log(f"[fleet] kernel calls by brain (its serving threads): {json.dumps(per_brain)}")
    log(f"[fleet] the three-member router's counters at its close "
        f"{json.dumps(out['router_counters'])}")
    del brains, extra
    _free_cuda()
    report["fleet"] = out


# ------------------------------------------------------------ devobs

DEVOBS_SLOTS = 8
DEVOBS_WARM = "search for wireless headphones"  # its suffix fills the 32-token bucket
# its suffix (61 tokens past the 879-token prefix) takes the 64-token bucket
DEVOBS_COLD = ("search for wireless noise cancelling headphones under two hundred dollars "
               "and sort them by customer rating")


def phase_devobs(params, totals: dict, report: dict) -> None:
    """Device observability on the batch cell's brain (tinyllama-1.1b int8,
    ff 8, the cached prefix, 8 paged slots) on the service phase's weights:
    the build phase's ``ops._lib.build`` event; with every site cold again
    (``forget_signatures``), the warm-up parses' events; the fence armed,
    then a repeated parse pays no post-fence event; a prompt whose suffix
    takes the cold 64-token bucket pays exactly one, named, which shows in
    ``/health``'s warning, in ``xla.compiles_post_fence`` and on its step in
    the ledger. The ledger's plan against the engine's tensors and
    ``torch.cuda.memory_stats``; the ``_qe`` audit of a decode step
    (``utils.perfdiag``: count and MB of the int8 -> bf16 weight copies);
    a ``capture_profile`` Chrome trace of one request."""
    import torch

    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.utils import compilewatch, perfdiag
    from tpu_voice_agent_torch.utils.hbmledger import hbm_report
    from tpu_voice_agent_torch.utils.steplog import get_steplog
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    out = {"build_event": report.get("build_event")}
    log(f"[devobs] the build phase's event: {out['build_event']}")
    w = compilewatch.get_compile_watcher()
    w.reset()
    compilewatch.forget_signatures()
    eng = _paged_engine(params, 8, batch_slots=DEVOBS_SLOTS, radix_enable=False)
    P = brain.install_prompt_prefix(eng)
    parser = brain.BatchedEngineParser(eng, chunk_steps=16, max_new_tokens=BATCH_NEW_TOKENS)
    app = brain.BrainApp(parser)

    def parse(text: str) -> int:
        status, body, _ = app.parse(json.dumps({"text": text, "context": {}}).encode())
        fail_if(status not in (200, 422), f"devobs: /parse {text!r} answered {status} {body}")
        return status

    try:
        with Counted("devobs", totals) as c:
            warm = [parse(DEVOBS_WARM) for _ in range(2)]
            out["warmup_events"] = [{k: e[k] for k in ("site", "ms", "shape")}
                                    for e in w.events()]
            log(f"[devobs] prefix {P} tokens; warm-up parses {warm}: {len(w.events())} events "
                f"{out['warmup_events']}")
            # the audit's B = 1 forward is cold too: before the fence
            events = perfdiag.decode_step_profile(eng)
            audit = perfdiag.audit_dequant(events)
            every = perfdiag.audit_dequant(events, min_bytes=1)
            out["audit"] = {"findings_8mb": len(audit["findings"]),
                            "mb_8mb": sum(f[3] for f in audit["findings"]),
                            "findings_all": len(every["findings"]),
                            "mb_all": round(sum(f[3] for f in every["findings"]), 1),
                            "scanned": audit["scanned_instructions"]}
            cfg = eng.cfg
            fail_if(out["audit"]["findings_all"] != 7 * cfg.n_layers + 1,
                    f"devobs: the _qe audit found {out['audit']['findings_all']} int8 copies, "
                    f"want one a quantized matmul ({7 * cfg.n_layers + 1})")
            log(f"[devobs] _qe audit of one decode step: {out['audit']}")
            w.arm_fence("devobs warm-up complete")
            get_steplog().clear()
            post0 = get_metrics().snapshot()["counters"].get("xla.compiles_post_fence", 0.0)
            parse(DEVOBS_WARM)
            fail_if(w.state()["post_fence_compiles"] != 0,
                    f"devobs: a repeated parse paid post-fence events: {w.events(last=4)}")
            parse(DEVOBS_COLD)
        c.require("paged_block_attention", "masked_argmax_advance")
        st = w.state()
        post = [e for e in w.events() if e["post_fence"]]
        steps = [e for s in get_steplog().steps() for e in s["events"] if e["post_fence"]]
        status, health, _ = app.health()
        cs = health.get("compile_sentinel", {})
        counter = get_metrics().snapshot()["counters"].get("xla.compiles_post_fence", 0.0) - post0
        out["post_fence"] = {"events": post, "in_steplog": len(steps), "counter": counter,
                             "health_warning": cs.get("warning")}
        log(f"[devobs] cold bucket: {len(post)} post-fence event(s) {post}; step ledger "
            f"{len(steps)}, xla.compiles_post_fence +{counter:g}; /health {cs.get('warning')!r}")
        fail_if(len(post) != 1 or "forward_paged" not in post[0]["site"]
                or "int32[1,64]" not in post[0]["shape"] or len(steps) != 1 or counter != 1
                or st["post_fence_compiles"] != 1 or "recompile(s) after the warmup fence"
                not in (cs.get("warning") or ""),
                f"devobs: the cold-bucket drill did not surface once everywhere: {out}")
        # the ledger's plan against the engine's tensors and the allocator
        rep = hbm_report(eng)
        meas, plan = rep["measured"], rep["plan"]
        stats = torch.cuda.memory_stats()
        out["ledger"] = {"plan": plan, "measured": meas, "drift": rep["drift"],
                         "allocated_bytes": stats["allocated_bytes.all.current"],
                         "reserved_bytes": stats["reserved_bytes.all.current"],
                         "health_hbm": health.get("hbm")}
        log(f"[devobs] ledger: plan {plan}, measured {meas}, drift {rep['drift']}; allocator "
            f"allocated {out['ledger']['allocated_bytes']} reserved "
            f"{out['ledger']['reserved_bytes']}; /health hbm {health.get('hbm')}")
        fail_if(meas["kv_pool_bytes"] != plan["kv_pool_bytes"]
                or abs(rep["drift"]) > float(os.environ.get("HBM_DRIFT_WARN", "0.15"))
                or meas["live_bytes"] < meas["weights_bytes"] + meas["kv_pool_bytes"]
                or not health.get("hbm"),
                f"devobs: the ledger does not reconcile: {out['ledger']}")
    finally:
        parser.close()
    # one request under the profiler, the engine idle (its loop stopped)
    out_dir = os.path.join(OUT_DIR, "devobs")
    t0 = time.perf_counter()
    path = perfdiag.capture_profile(eng, _batch_prompt(0), out_dir, max_new_tokens=4)
    out["trace"] = {"path": os.path.relpath(path, ROOT), "bytes": os.path.getsize(path),
                    "seconds": time.perf_counter() - t0}
    with open(path) as f:
        n_events = len(json.load(f)["traceEvents"])
    out["trace"]["events"] = n_events
    log(f"[devobs] capture_profile: {out['trace']}")
    fail_if(n_events == 0, "devobs: the Chrome trace holds no event")
    w.reset()  # later phases start with a disarmed, empty sentinel
    report["devobs"] = out


PLANNER_BUCKETS = (1024, 2048, 4096, 8192)  # LongSessionPlanner's default context buckets
PLANNER_NEW_TOKENS = 32  # of the served 256 a plan: a depth the script's time limit sets
PLANNER_SP_MERGE = 4  # the ring's sp for the multi-block merge on one card


def _planner_transcript(tokens_wanted: int, tok) -> str:
    """A session transcript of about ``tokens_wanted`` tokens: the rendered
    prompt, then turns and result lines as the planner keeps them."""
    from tpu_voice_agent_torch.services.prompts import render_prompt

    text, i = render_prompt(UTTERANCES[0], {}), 0
    while len(tok.encode(text, bos=True)) < tokens_wanted:
        text += (f"\n<|user|>\n{{\"text\":\"{UTTERANCES[i % len(UTTERANCES)]}\",\"context\":{{}}}}"
                 f"\n<|assistant|>\nresult {i}: 24 items, page {i % 7}, sorted by price\n")
        i += 1
    return text


def _planner_identity(planner, p, tokens, n: int, label: str, ulps: float) -> dict:
    """``llama_sp_prefill`` at sp 1 against the dense fresh-block forward
    (K1 over the block) on one bucket: the k/v cache, and the last logits
    within ``ulps`` bf16 ulps of the top logit (the lm_head runs over one
    row against the bucket's, another product shape)."""
    import torch

    from tpu_voice_agent_torch.models.llama import forward, init_kv_cache
    from tpu_voice_agent_torch.parallel import llama_sp_prefill

    S, dev = tokens.shape[1], tokens.device
    logits, kv = llama_sp_prefill(p, planner.cfg, tokens, planner.mesh,
                                  torch.tensor([n - 1], device=dev))
    cache = init_kv_cache(planner.cfg, 1, S, dtype=kv["k"].dtype, device=dev)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None]
    ref = forward(p, planner.cfg, tokens, positions, cache, fresh_block=True)[0][:, n - 1]
    d, top = float((logits - ref).abs().max()), float(ref.abs().max())
    kv_abs, kv_ratio = attn_err([(kv["k"], cache["k"]), (kv["v"], cache["v"])])
    out = {"logits_max_abs_diff": d, "top_logit": top, "ulps": d / (2.0 ** -8 * top),
           "kv_max_abs_err": kv_abs, "kv_equal": all(torch.equal(kv[x], cache[x])
                                                     for x in ("k", "v"))}
    log(f"[planner] {label}: sp prefill vs dense forward over {S}: last logits "
        f"{out['ulps']:.3f} bf16 ulps of the top logit apart (limit {ulps}), k/v equal "
        f"{out['kv_equal']} (max abs err {kv_abs:.3g})")
    fail_if(out["ulps"] > ulps, f"planner: {label}: the sp prefill's last logits part from the "
            f"dense forward's by {out['ulps']:.3f} bf16 ulps")
    fail_if(kv_ratio > 1.0, f"planner: {label}: the sp prefill's k/v is {kv_ratio:.3g}x the "
            f"tolerance from the dense forward's")
    return out


def phase_planner(totals: dict, report: dict) -> None:
    """The long-session planner on the card (tinyllama-1.1b on the weights
    the ``planner`` backend serves: random bf16 from seed 0, sp 1): the ring's multi-block merge at sp 4 over
    one card against one K1 call (T = 8192); ``llama_sp_prefill`` against
    the dense fresh-block forward on the 2048 bucket (bf16, and an fp32-
    activation twin at one ulp); cold-start prefill ms per context bucket;
    a cold start (2048), plan, warm extend, plan, re-anchor (4096), plan; a
    session in the 8192 bucket; ``plan_many`` of 4 sessions against 4
    sequential plans with every slot 0 intact; one plan's idle share under
    the profiler; the plans' tokens/s. Then BRAIN_BACKEND=planner-distilled over HTTP
    on the 6 golden dialogs against ``data/planner_golden.json``, a
    BRAIN_BACKEND=planner brain answering two turns of one session, and
    BRAIN_SP past the cards refused at boot."""
    import torch

    from tpu_voice_agent_torch import ops
    from tpu_voice_agent_torch.evals.golden import score_parser_dialogs
    from tpu_voice_agent_torch.parallel import llama_sp_prefill, ring_attention, sp_mesh
    from tpu_voice_agent_torch.serve.planner import LongSessionPlanner
    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.services.prompts import render_prompt

    out: dict = {"section_s": {}}
    t_sec = [time.perf_counter()]

    def section(name: str) -> None:  # the wall of each part of the phase
        now = time.perf_counter()
        out["section_s"][name] = now - t_sec[0]
        t_sec[0] = now

    mesh = sp_mesh(1)
    dev = mesh[0]

    # the ring's merge path: sp 4 over one card against one K1 call
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(1, PLANNER_T, h, 64, generator=g, device=dev).to(torch.bfloat16)
               for h in (32, 4, 4))
    mesh4 = sp_mesh(PLANNER_SP_MERGE, [dev] * PLANNER_SP_MERGE)
    r_abs, r_ratio = attn_err([(ring_attention(q, k, v, mesh4, causal=True),
                                ops.flash_attention(q, k, v, causal=True))])
    out["ring_sp4"] = {"max_abs_err": r_abs, "err_over_tol": r_ratio,
                       "ms": cuda_ms(lambda: ring_attention(q, k, v, mesh4), iters=3),
                       "one_k1_ms": cuda_ms(lambda: ops.flash_attention(q, k, v), iters=3)}
    log(f"[planner] ring_attention at sp {PLANNER_SP_MERGE} over one card vs one K1 call, "
        f"causal T = {PLANNER_T}: max abs err {r_abs:.3g} ({r_ratio:.3g} of tol {ATTN_TOL}); "
        f"{out['ring_sp4']['ms']:.3f} ms vs {out['ring_sp4']['one_k1_ms']:.3f} ms")
    fail_if(r_ratio > 1.0, f"planner: the sp-{PLANNER_SP_MERGE} ring merge is {r_ratio:.3g}x "
            "its tolerance from one K1 call")
    del q, k, v
    section("ring merge")

    planner = LongSessionPlanner(preset="tinyllama-1.1b", mesh=mesh)  # as the backend builds it
    fail_if(planner.params["embed"].dtype != torch.bfloat16 or planner.device != dev,
            f"planner: weights {planner.params['embed'].dtype} on {planner.device}")
    tok, cfg = planner.tokenizer, planner.cfg
    prompt = render_prompt(UTTERANCES[0], {})
    ids = tok.encode(prompt, bos=True)
    n = len(ids)

    def bucket_tokens(S: int):
        t = torch.full((1, S), planner.pad_id, dtype=torch.int32)
        t[0, :n] = torch.tensor(ids, dtype=torch.int32)
        return t.to(dev)

    out["identity_bf16"] = _planner_identity(planner, planner.params, bucket_tokens(2048), n,
                                             "bf16", BF16_PART_ULPS)
    out["identity_fp32"] = _planner_identity(planner, _fp32_activations(planner.params),
                                             bucket_tokens(2048), n, "fp32 activations", 1)
    section("sp prefill identity")

    plans: list = []

    def plan(sess, label: str):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text, pids = planner.plan(sess, max_new_tokens=PLANNER_NEW_TOKENS)
        s = time.perf_counter() - t0
        fail_if(not pids or planner.fsm.walk(pids) < 0,
                f"planner: {label}: the plan left the grammar ({len(pids)} tokens)")
        plans.append({"label": label, "bucket": int(sess.cache["k"].shape[2]),
                      "tokens": len(pids), "ms": s * 1e3})
        log(f"[planner] {label}: plan of {len(pids)} tokens in {s * 1e3:.1f} ms at bucket "
            f"{plans[-1]['bucket']}, position {sess.pos}")
        return pids

    with Counted("planner", totals) as c:
        t0 = time.perf_counter()
        out["prefill_ms"] = {}
        for S in PLANNER_BUCKETS:
            toks = bucket_tokens(S)
            for _ in range(2):  # the second call is the one timed
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                llama_sp_prefill(planner.params, cfg, toks, mesh,
                                 torch.tensor([n - 1], device=dev))
                torch.cuda.synchronize()
            out["prefill_ms"][S] = (time.perf_counter() - t1) * 1e3
        log(f"[planner] cold-start prefill ms per bucket (sp 1): {out['prefill_ms']}")
        section("prefill per bucket")

        sess = planner.start(prompt)
        fail_if((sess.anchors, int(sess.cache["k"].shape[2])) != (1, 2048),
                f"planner: the cold start is in bucket {sess.cache['k'].shape[2]}, not 2048")
        plan(sess, "cold start")
        pos0 = sess.pos
        user = json.dumps({"text": UTTERANCES[1], "context": {}}, separators=(",", ":"))
        planner.extend(sess, f"\n<|user|>\n{user}\n<|assistant|>\n")
        fail_if(sess.anchors != 1 or sess.pos <= pos0, "planner: the warm extend re-anchored")
        plan(sess, "warm extend")
        # past the extend buckets and the 2048 bucket's headroom: one ring
        # prefill of the whole transcript into 4096
        planner.extend(sess, _planner_transcript(2600, tok)[len(prompt):])
        fail_if((sess.anchors, int(sess.cache["k"].shape[2])) != (2, 4096),
                f"planner: the re-anchor went to bucket {sess.cache['k'].shape[2]} "
                f"({sess.anchors} anchors), not 4096")
        plan(sess, "re-anchored")
        big = planner.start(_planner_transcript(6000, tok))
        fail_if(int(big.cache["k"].shape[2]) != 8192,
                f"planner: a {len(big.ids)}-token transcript is in bucket "
                f"{big.cache['k'].shape[2]}, not 8192")
        plan(big, f"{len(big.ids)}-token session")

        section("sessions")
        texts = [render_prompt(t, {}) for t in UTTERANCES[:4]]
        batch = [planner.start(t) for t in texts]
        alone = [planner.start(t) for t in texts]
        prompt_ids = [list(s.ids) for s in batch]
        slot0 = [(s.cache["k"][:, 0, 0].clone(), s.cache["v"][:, 0, 0].clone()) for s in batch]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = planner.plan_many(batch, max_new_tokens=PLANNER_NEW_TOKENS)
        batch_ms = (time.perf_counter() - t1) * 1e3
        seq = [plan(s, f"sequential {i}") for i, s in enumerate(alone)]
        fail_if(any(not (torch.equal(s.cache["k"][:, 0, 0], k0)
                         and torch.equal(s.cache["v"][:, 0, 0], v0))
                    for s, (k0, v0) in zip(batch, slot0)),
                "planner: plan_many changed a session's slot 0")
        equal = sum(a == b for (_, a), b in zip(got, seq))
        diverged = _partings(planner, prompt_ids, seq, [b for _, b in got], "planner",
                             "plan_many and plan")
        _check_partings(diverged, "planner", BF16_PART_ULPS)
        out["plan_many"] = {"sessions": 4, "ms": batch_ms, "equal": equal,
                            "partings": diverged,
                            "tokens": [len(b) for _, b in got]}
        log(f"[planner] plan_many of 4 sessions in {batch_ms:.1f} ms: {equal} / 4 equal to "
            f"the sequential plans, every slot 0 intact")

        section("plan_many")
        holder = [planner.start(prompt) for _ in range(2)]
        out["profile"] = _plan_idle_share(planner, holder)
        out["wall_s"] = time.perf_counter() - t0
        section("profiled plan")
    # every ring prefill is one K1 launch with lse a layer (sp 1): the
    # bucket timings and every anchor of every session
    prefills = 2 * len(PLANNER_BUCKETS) + sum(s.anchors for s in [sess, big, *batch, *alone,
                                                                    *holder])
    c.require("flash_attention", "decode_attention_layer", "masked_argmax_advance")
    layers = cfg.n_layers
    fail_if(c.counts["flash_attention"] != layers * prefills,
            f"planner: {c.counts['flash_attention']} K1 launches over "
            f"{prefills} ring prefills of {layers} layers")
    tokens = sum(p["tokens"] for p in plans)
    out["plans"] = plans
    out["plan_tok_per_s"] = tokens / (sum(p["ms"] for p in plans) / 1e3)
    out["plan_idle_share"] = out["profile"]["idle_share"]
    log(f"[planner] plan decode {out['plan_tok_per_s']:.1f} tok/s over {len(plans)} plans "
        f"(idle share {out['plan_idle_share']})")
    del planner, batch, alone, sess, big, holder

    saved = {k: os.environ.get(k) for k in ("BRAIN_BACKEND", "BRAIN_DEVICE", "BRAIN_SP",
                                            "BRAIN_QUANT", "BRAIN_FF", "BRAIN_BATCH")}
    for k in saved:
        os.environ.pop(k, None)
    try:
        out["distilled"] = _planner_distilled(dev, totals, score_parser_dialogs)
        section("planner-distilled")
        out["planner_backend"] = _planner_backend(totals)
        section("planner backend")
        cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        os.environ.update(BRAIN_BACKEND="planner:test-tiny", BRAIN_SP=str(cards + 1))
        try:
            brain.make_parser_from_env()
            refused = None
        except ValueError as e:
            refused = str(e)
        fail_if(refused is None or "BRAIN_SP" not in refused,
                f"planner: BRAIN_SP past the cards booted (refusal: {refused})")
        out["sp_refusal"] = refused
        log(f"[planner] BRAIN_SP={os.environ['BRAIN_SP']} refused at boot: {refused}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"[planner] seconds by part: { {k: round(v, 2) for k, v in out['section_s'].items()} }")
    report["planner"] = out


PLANNER_PROFILE_TOKENS = 8  # a plan under the profiler: its trace's size sets the cost


def _plan_idle_share(planner, sessions: list) -> dict:
    """One plan's device idle share: 1 - the device time of its kernels
    (``torch.profiler``, CUDA activity only: recording every host op of a
    plan cost 45 s on the card) over the wall of the same plan on a twin
    session, unprofiled. The top kernels by device time are printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = len(planner.plan(sessions[0], max_new_tokens=PLANNER_PROFILE_TOKENS)[1])
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        planner.plan(sessions[1], max_new_tokens=PLANNER_PROFILE_TOKENS)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    busy_us = sum(_device_us(e) for e in kernels)
    launched = sum(e.count for e in kernels)
    top = [f"{_device_us(e):10.1f} us {e.count:6d}x  {e.key[:90]}"
           for e in sorted(kernels, key=_device_us, reverse=True)[:6]]
    res = {"tokens": n, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "idle_share": 1 - busy_us / wall_us, "kernels": launched, "top": top}
    log(f"[planner] one plan of {n} tokens: wall {wall_us / 1e3:.2f} ms (unprofiled), device "
        f"busy {busy_us / 1e3:.2f} ms, idle share {res['idle_share']:.3f}, {launched} kernels")
    for ln in top:
        log(f"[planner]   {ln}")
    return res


def _planner_distilled(dev, totals: dict, score_parser_dialogs) -> dict:
    """BRAIN_BACKEND=planner-distilled on the card over HTTP, the 6 golden
    dialogs with session ids: every turn's plan tokens equal to
    ``data/planner_golden.json`` (fp32 checkpoint), and the dialogs' score."""
    from tpu_voice_agent_torch import PACKAGE_DIR
    from tpu_voice_agent_torch.services import brain

    golden = json.loads((PACKAGE_DIR / "data" / "planner_golden.json").read_text())
    os.environ["BRAIN_BACKEND"] = "planner-distilled"
    with Counted("planner_distilled", totals) as c:
        parser = brain.make_parser_from_env()
        fail_if(parser.planner.device != dev, f"planner-distilled: on {parser.planner.device}")
        plans: list = []
        inner = parser._gather.plan

        def recorded(sess, max_new):
            res = inner(sess, max_new)
            plans.append(list(res[1]))
            return res

        parser._gather.plan = recorded
        server, thread, base = _serve_brain(brain.BrainApp(parser))

        class _Http:
            def parse(self, text, context, session_id=None):
                status, body = _post(base, {"text": text, "context": context,
                                            "session_id": session_id})
                if status != 200:
                    raise RuntimeError(f"/parse {text!r}: {status} {body}")
                return body

        try:
            t0 = time.perf_counter()
            score = score_parser_dialogs(_Http(), session=True)
            wall = time.perf_counter() - t0
        finally:
            _stop(server, thread)
    c.require("flash_attention", "decode_attention_layer", "masked_argmax_advance")
    want = [t["token_ids"] for d in golden["dialogs"] for t in d]
    equal = sum(a == b for a, b in zip(plans, want))
    log(f"[planner] planner-distilled over HTTP: {len(plans)} turns in {wall:.2f} s, {equal} / "
        f"{len(want)} equal to planner_golden.json; score_parser_dialogs {score}")
    fail_if(plans != want, f"planner-distilled: {len(want) - equal} turns differ from "
            "planner_golden.json")
    return {"turns": len(plans), "equal": equal, "wall_s": wall, "score": score}


def _planner_backend(totals: dict) -> dict:
    """BRAIN_BACKEND=planner (tinyllama-1.1b, random bf16 weights) boots on
    the card and answers two turns of one session over HTTP (a random
    model may truncate: 422, which drops the session, is the legal
    failure). Its plans are cut to PLANNER_NEW_TOKENS."""
    from tpu_voice_agent_torch.services import brain

    os.environ["BRAIN_BACKEND"] = "planner"
    with Counted("planner_backend", totals) as c:
        t0 = time.perf_counter()
        parser = brain.make_parser_from_env()
        boot = time.perf_counter() - t0
        parser.max_new_tokens = PLANNER_NEW_TOKENS
        server, thread, base = _serve_brain(brain.BrainApp(parser))
        try:
            answers = []
            for text in UTTERANCES[:2]:
                status, body = _post(base, {"text": text, "context": {}, "session_id": "p1"})
                fail_if(status not in (200, 422), f"planner: /parse {text!r}: {status} {body}")
                answers.append(status)
        finally:
            _stop(server, thread)
    c.require("flash_attention", "decode_attention_layer", "masked_argmax_advance")
    log(f"[planner] BRAIN_BACKEND=planner booted in {boot:.2f} s (sp {parser.planner.sp}, "
        f"{parser.planner.cfg.n_layers} layers); two turns of one session: {answers}")
    return {"boot_s": boot, "answers": answers}


PARALLEL_SLOTS = 4  # BRAIN_BATCH of the meshed engines: dp 2 x 2 rows
PARALLEL_NEW_TOKENS = 32  # of the parse's 64: a depth the script's time limit sets
# of tinyllama-1.1b's 22 (the service weights' first layers, pp 2 stages of
# 4): a depth the script's time limit sets; every meshed forward launches
# per layer per shard
PARALLEL_LAYERS = 8
PARALLEL_DEVICE = "cuda:0"  # the one card every mesh device is


def _tp2_shard_rows(mesh, rows: dict) -> dict:
    """Each sharded wrapper on the (2, 2) mesh of one card against its
    plain version over the whole operands, at the meshed engine's shapes
    (a tp-2 shard of tinyllama-1.1b: 16 q / 2 kv heads of 64; dp 2 of 4
    rows); K1 / K2 / K3 also timed at one shard's shape beside their plain
    versions and SDPA, kept as the ``tp2_shard`` shape of their rows. K4 /
    K11 exactly equal."""
    import torch

    from tpu_voice_agent_torch import ops

    dev = torch.device(PARALLEL_DEVICE)
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    nq, nkv, hd, S, B = 32, 4, 64, 2048, PARALLEL_SLOTS
    T = 1024
    q1, k1, v1 = randn(1, T, nq, hd), randn(1, T, nkv, hd), randn(1, T, nkv, hd)
    q2, kc, vc = randn(B, nq, hd), randn(1, B, S, nkv, hd), randn(1, B, S, nkv, hd)
    kv_len = torch.tensor([1, 880, 1500, 2048], dtype=torch.int32, device=dev)
    front = [0, 880, 1200, 2030]
    pos = torch.tensor([[f + min(i, 5) for i in range(9)] for f in front], dtype=torch.int32,
                       device=dev)
    q3 = randn(B, 9, nq, hd)
    pairs = [
        (ops.sharded_flash_attention(mesh, q1, k1, v1, causal=True).full(),
         ops.attention_reference(q1, k1, v1, causal=True)),
        (ops.sharded_decode_attention_layer(mesh, q2, kc, vc, kv_len, 0).full(),
         ops.decode_attention_reference(q2, kc[0], vc[0], kv_len)),
        (ops.sharded_decode_block_attention_layer(mesh, q3, kc, vc, pos, 0).full(),
         ops.decode_block_attention_reference(q3, kc[0], vc[0], pos)),
        (ops.sharded_decode_attention(mesh, q2, kc[0], vc[0], kv_len).full(),
         ops.decode_attention_reference(q2, kc[0], vc[0], kv_len)),
    ]
    err, ratio = attn_err(pairs)
    fail_if(not ratio <= 1.0, f"parallel: a sharded attention wrapper is {ratio:.3g}x its "
            f"tolerance {ATTN_TOL} (max abs err {err})")
    from tpu_voice_agent_torch.grammar import build_intent_fsm

    _tok, fsm = build_intent_fsm()
    t = fsm.device_tables(device=dev)
    V = fsm.vocab_size + 1  # the tp-2 engine's padded width, the padded id dead
    mask = torch.cat([t.dense_mask, torch.zeros((fsm.num_states, 1), dtype=torch.bool,
                                                device=dev)], dim=1)
    table = t.table
    col = torch.cat([t.col_id, torch.zeros(1, dtype=t.col_id.dtype, device=dev)])
    logits = randn(B, 5, V, dtype=torch.float32)
    states = torch.randint(0, fsm.num_states, (B, 5), generator=g, device=dev,
                           dtype=torch.int32)
    tok, nxt = ops.sharded_masked_argmax_advance(mesh, logits[:, 0].contiguous(),
                                                 states[:, 0].contiguous(), mask, table, col)
    rt, rn = ops.masked_argmax_advance_reference(logits[:, 0], states[:, 0], mask, table, col)
    blk = ops.sharded_masked_argmax_block(mesh, logits, states, mask).full()
    fail_if(not (torch.equal(tok.full(), rt) and torch.equal(nxt.full(), rn)),
            "parallel: sharded K4 differs from its plain version")
    fail_if(not torch.equal(blk, ops.masked_argmax_reference(
        logits.reshape(-1, V), states.reshape(-1), mask).reshape(B, 5)),
        "parallel: sharded K11 differs from its plain version")
    log(f"[parallel] sharded K1 / K2 / K3 / K5 against their plain versions: max abs err "
        f"{err:.3g} ({ratio:.3g} of tol {ATTN_TOL}); K4 / K11 equal over {B} rows of {V}")
    out = {"max_abs_err": err, "err_over_tol": ratio}
    # one shard's shapes: 16 / 2 heads, B / dp = 2 rows
    h, kh = nq // 2, nkv // 2
    qs1, ks1, vs1 = (x[:, :, :n].contiguous() for x, n in ((q1, h), (k1, kh), (v1, kh)))
    if "flash_attention" in rows:
        import torch.nn.functional as F

        qh, kk, vv = (qs1.transpose(1, 2), ks1.transpose(1, 2).repeat_interleave(8, 1),
                      vs1.transpose(1, 2).repeat_interleave(8, 1))
        rows["flash_attention"]["tp2_shard"] = _extra_shape(
            "a tp-2 shard of the prefix prefill: causal T = S = 1024, 16/2 heads, hd 64, bf16",
            cuda_ms(lambda: ops.flash_attention(qs1, ks1, vs1, causal=True)),
            cuda_ms(lambda: ops.attention_reference(qs1, ks1, vs1, causal=True), iters=5),
            *bound(2 * (2 * T * h * hd + 2 * T * kh * hd), 4 * h * hd * T * (T + 1) / 2),
            cuda_ms(lambda: F.scaled_dot_product_attention(qh, kk, vv, is_causal=True)))
    shard = {"q": q2[:2, :h].contiguous(), "k": kc[:, :2, :, :kh].contiguous(),
             "v": vc[:, :2, :, :kh].contiguous(), "kv_len": kv_len[:2].contiguous(),
             "label": "a tp-2 shard of the meshed step: 2 rows, 16/2 heads, kv_len [1, 880]"}
    if "decode_attention_layer" in rows:
        rows["decode_attention_layer"]["tp2_shard"] = _k2_extra_row(shard)
    if "decode_block_attention_layer" in rows:
        rows["decode_block_attention_layer"]["tp2_shard"] = _k3_extra_row(
            {"q": q3[:2, :, :h].contiguous(), "k": shard["k"], "v": shard["v"],
             "pos": pos[:2].contiguous(),
             "label": "a tp-2 shard of the ff 8 chain: (2, 9), 16/2 heads, frontiers [0, 880]"})
    return out


def _mesh_drain(eng, prompts, label: str, totals: dict, *kernels) -> dict:
    """The prompts through a ContinuousBatcher on ``eng`` (chunk 16,
    PARALLEL_NEW_TOKENS), counted: every result ok and in the grammar, each
    kernel in ``kernels`` launched. Returns the results, wall, tokens,
    forwards and counts."""
    import torch

    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher

    b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=PARALLEL_NEW_TOKENS)
    with Counted(label, totals) as c:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = b.generate_many(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    c.require(*kernels)
    fail_if(any(r.error is not None for r in res), f"{label}: "
            f"{[r.error for r in res if r.error][:3]}")
    fail_if(min(eng.fsm.walk(r.token_ids) for r in res) < 0,
            f"{label}: a token stream left the grammar")
    tokens = sum(r.steps for r in res)
    log(f"[{label}] {len(res)}/{len(res)} ok, {tokens} tokens in {wall:.3f} s "
        f"({tokens / wall:.1f} tok/s), {b.forwards} forwards")
    return {"res": res, "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "forwards": b.forwards, "counts": c.counts}


def _parse_wall(eng, prompt) -> float:
    """One request alone through the batcher (admission and decode), ms."""
    import torch

    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher

    b = ContinuousBatcher(eng, chunk_steps=16, max_new_tokens=PARALLEL_NEW_TOKENS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.generate_many([prompt])
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _chunk_idle_share(eng, prompts) -> float:
    """One 4-step decode chunk's device idle share after the prompts'
    admission: 1 - the device time of its kernels (``torch.profiler``, CUDA
    activity) over the same chunk's wall, both read inside the profile; the
    chunk must start with a live row. The batcher is then dropped: a dense
    or staged cache holds no slot state to release."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_voice_agent_torch.serve.scheduler import ContinuousBatcher

    # chunks of 4 steps: at ff 8 a 16-step chunk can finish every row
    b = ContinuousBatcher(eng, chunk_steps=4, max_new_tokens=PARALLEL_NEW_TOKENS)
    for p in prompts:
        b.submit(p)
    b.step()  # the admissions and the first chunk
    torch.cuda.synchronize()
    fail_if(not b._active_h.any(), "parallel: every row finished in the admitting chunk; "
            "no decode chunk left to profile")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        b.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(_device_us(e) for e in prof.key_averages() if e.device_type != DeviceType.CPU)
    return 1 - busy / wall_us


def phase_parallel(params, rows: dict, totals: dict, report: dict) -> None:
    """The dp x tp mesh and the pp x tp pipeline (``parallel/``,
    ``serve/pp_engine.py``) on the card, over meshes of four devices that
    are all the one card ([cuda:0] x 4: every shard's blocks and launches
    are real, the cards shared), at tinyllama-1.1b's width int8 on the
    first PARALLEL_LAYERS of the service phase's layers: each sharded
    wrapper against its plain version
    (``_tp2_shard_rows``); the dense engine on a dp 2 x tp 2 mesh (4
    slots, vocab padded to 620) behind the cached prefix (K1 per shard),
    serving the five typed commands (32 new tokens) at ff 8 (K3 per
    shard: exactly PARALLEL_LAYERS x 4 a forward; K4 per dp shard) against the
    unmeshed engine, then spec
    k = 4 on the same mesh (K3, K11 per shard) and ff 0 (K2 per shard)
    against each other; a twin of the ff 8 comparison with fp32
    activations; ``PPDecodeEngine`` at pp 2 x tp 2 (int8, ff 0, the cached
    prefix) against the unmeshed ff 0 engine, and its fp32 twin. Streams
    equal, or parted within ``BF16_PART_ULPS`` of the plain forward's
    top-2 margin (one ulp in the fp32 twins: the tp sums reorder
    additions). The parse wall, tok/s and one chunk's device idle share at
    2 x 2 against 1 x 1. Then BRAIN_BACKEND=pp through the brain service at
    its one-card defaults (pp 1, tp 1) answering /parse and /health, and
    the refusals: a paged engine on a mesh, BRAIN_PP past the cards."""
    import dataclasses

    import torch

    from tpu_voice_agent_torch.models.llama import PRESETS
    from tpu_voice_agent_torch.parallel.mesh import make_mesh
    from tpu_voice_agent_torch.parallel.pipeline import pp_tp_mesh
    from tpu_voice_agent_torch.serve.engine import DecodeEngine, pad_vocab
    from tpu_voice_agent_torch.serve.paged import PagedDecodeEngine
    from tpu_voice_agent_torch.serve.pp_engine import PPDecodeEngine
    from tpu_voice_agent_torch.serve.spec import SpecConfig
    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix
    from tpu_voice_agent_torch.services.prompts import render_prompt

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(PARALLEL_DEVICE)
    mesh = make_mesh(2, 2, [dev] * 4)
    out = {"wrappers": _tp2_shard_rows(mesh, rows)}
    prompts = [render_prompt(text, {}) for text in UTTERANCES]  # the five typed commands
    cfg = dataclasses.replace(PRESETS["tinyllama-1.1b"], n_layers=PARALLEL_LAYERS)
    params = {**params, "layers": params["layers"][:PARALLEL_LAYERS]}  # the engine's per-layer list
    kw = dict(cfg=cfg, quant="int8", max_len=2048, batch_slots=PARALLEL_SLOTS,
              prefill_buckets=(1024,), init_weights=False)

    def prefix(e, label):
        with Counted(label, totals) as c:
            P = install_prompt_prefix(e)
        return P, c.counts

    ids = None
    for dtype, p in (("bf16", params), ("fp32", _fp32_activations(params))):
        one = DecodeEngine(fast_forward=8, **kw)
        one.load_params(p)
        ids = [one.tokenizer.encode(pr, bos=True) for pr in prompts]
        m8 = DecodeEngine(mesh=mesh, fast_forward=8, **kw)
        m8.load_params(pad_vocab(p, m8.cfg.vocab_size))
        P, c_pre = prefix(m8, f"parallel {dtype} 2x2 prefix")
        fail_if(c_pre.get("flash_attention") != PARALLEL_LAYERS * 2,
                f"parallel: the meshed prefix launched K1 {c_pre.get('flash_attention')} times, "
                f"want {PARALLEL_LAYERS} layers x 2 tp shards of dp group 0")
        prefix(one, f"parallel {dtype} 1x1 prefix")
        r1 = _mesh_drain(one, prompts, f"parallel {dtype} 1x1 ff=8", totals,
                         "decode_block_attention_layer", "masked_argmax_advance")
        r4 = _mesh_drain(m8, prompts, f"parallel {dtype} 2x2 ff=8", totals,
                         "decode_block_attention_layer", "masked_argmax_advance")
        k3 = r4["counts"]["decode_block_attention_layer"]
        fail_if(k3 != PARALLEL_LAYERS * 4 * r4["forwards"],
                f"parallel: K3 launched {k3} times over {r4['forwards']} meshed forwards, want "
                f"{PARALLEL_LAYERS} layers x 4 shards each")
        ulps = 1 if dtype == "fp32" else BF16_PART_ULPS
        label = f"parallel {dtype} ff=8"
        diverged = _partings(one, ids, [r.token_ids for r in r1["res"]],
                             [r.token_ids for r in r4["res"]], label, "2x2 and 1x1")
        _check_partings(diverged, label, ulps)
        row = {"prefix_tokens": P, "diverged": diverged,
               "tokens_per_s": {"1x1": r1["tokens_per_s"], "2x2": r4["tokens_per_s"]},
               "launches": r4["counts"]}
        if dtype == "bf16":
            row["parse_ms"] = {"1x1": _parse_wall(one, prompts[0]),
                               "2x2": _parse_wall(m8, prompts[0])}
            row["idle_share"] = {"1x1": _chunk_idle_share(one, prompts),
                                 "2x2": _chunk_idle_share(m8, prompts)}
            log(f"[parallel] parse wall {row['parse_ms']['1x1']:.1f} ms at 1x1, "
                f"{row['parse_ms']['2x2']:.1f} ms at 2x2; tok/s {r1['tokens_per_s']:.1f} / "
                f"{r4['tokens_per_s']:.1f}; a chunk's idle share "
                f"{row['idle_share']['1x1']:.3f} / {row['idle_share']['2x2']:.3f}")
            # spec k = 4 and ff 0 on the same mesh, over m8's placed weights
            ms = DecodeEngine(mesh=mesh, fast_forward=0, spec=SpecConfig(k=SPEC_K), **kw)
            ms.load_params(m8.params)
            prefix(ms, "parallel 2x2 spec prefix")
            rs = _mesh_drain(ms, prompts, "parallel 2x2 spec", totals,
                             "decode_block_attention_layer", "masked_argmax")
            m0 = DecodeEngine(mesh=mesh, fast_forward=0, **kw)
            m0.load_params(m8.params)
            prefix(m0, "parallel 2x2 ff=0 prefix")
            r0 = _mesh_drain(m0, prompts, "parallel 2x2 ff=0", totals,
                             "decode_attention_layer", "masked_argmax_advance")
            k2 = r0["counts"]["decode_attention_layer"]
            fail_if(k2 != PARALLEL_LAYERS * 4 * r0["forwards"],
                    f"parallel: K2 launched {k2} times over {r0['forwards']} meshed forwards")
            d = _partings(one, ids, [r.token_ids for r in r0["res"]],
                          [r.token_ids for r in rs["res"]], "parallel 2x2 spec", "spec and ff=0")
            _check_partings(d, "parallel 2x2 spec", BF16_PART_ULPS)
            row.update(spec={"diverged": d, "launches": rs["counts"],
                             "tokens_per_s": rs["tokens_per_s"]},
                       ff0={"launches": r0["counts"], "tokens_per_s": r0["tokens_per_s"]})
            del ms, m0
        out[f"dense_{dtype}"] = row
        # the pp x tp pipeline at ff 0 against the unmeshed ff 0 engine
        one0 = DecodeEngine(fast_forward=0, **kw)
        one0.load_params(one.params)
        prefix(one0, f"parallel {dtype} 1x1 ff=0 prefix")
        pp = PPDecodeEngine(mesh=pp_tp_mesh(2, 2, [dev] * 4), **kw)
        pp.load_params(p)
        prefix(pp, f"parallel {dtype} pp 2x2 prefix")
        q1 = _mesh_drain(one0, prompts, f"parallel {dtype} 1x1 ff=0", totals,
                         "decode_attention_layer")
        qp = _mesh_drain(pp, prompts, f"parallel {dtype} pp 2x2 ff=0", totals,
                         "masked_argmax_advance")
        label = f"parallel {dtype} pp"
        d = _partings(one0, ids, [r.token_ids for r in q1["res"]],
                      [r.token_ids for r in qp["res"]], label, "pp 2x2 and 1x1")
        _check_partings(d, label, ulps)
        out[f"pp_{dtype}"] = {"diverged": d, "tokens_per_s": {"1x1": q1["tokens_per_s"],
                                                              "pp2x2": qp["tokens_per_s"]},
                              "launches": qp["counts"]}
        if dtype == "bf16":
            out["pp_bf16"]["parse_ms"] = {"1x1": _parse_wall(one0, prompts[0]),
                                          "pp2x2": _parse_wall(pp, prompts[0])}
            out["pp_bf16"]["idle_share"] = _chunk_idle_share(pp, prompts)
            log(f"[parallel] pp 2x2 parse wall {out['pp_bf16']['parse_ms']['pp2x2']:.1f} ms "
                f"(1x1 ff=0 {out['pp_bf16']['parse_ms']['1x1']:.1f} ms); tok/s "
                f"{qp['tokens_per_s']:.1f} / {q1['tokens_per_s']:.1f}; a chunk's idle share "
                f"{out['pp_bf16']['idle_share']:.3f}")
        del one, one0, m8, pp, p
        _free_cuda()
    # the brain service's pp backend at its one-card defaults
    _hf_env(BRAIN_BACKEND="pp")
    for k in ("BRAIN_PP", "BRAIN_TP"):
        os.environ.pop(k, None)
    with Counted("parallel pp backend", totals) as c:
        t0 = time.perf_counter()
        parser = brain.make_parser_from_env()
        boot = time.perf_counter() - t0
        parser.batcher.max_new_tokens = PARALLEL_NEW_TOKENS
        eng = parser.engine
        fail_if((eng.pp, eng.tp, eng.fast_forward) != (1, 1, 0),
                f"parallel: BRAIN_BACKEND=pp booted pp {eng.pp} x tp {eng.tp}, ff "
                f"{eng.fast_forward} on one card")
        server, thread, base = _serve_brain(brain.BrainApp(parser))
        try:
            status, body = _post(base, {"text": UTTERANCES[0], "context": {}})
            fail_if(status not in (200, 422), f"parallel: pp /parse {status} {body}")
            health = _health(base)
            fail_if(not health.get("batch_slots"), f"parallel: pp /health {health}")
        finally:
            _stop(server, thread)
            parser.close()
    c.require("masked_argmax_advance")
    log(f"[parallel] BRAIN_BACKEND=pp booted in {boot:.2f} s (pp 1 x tp 1 on one card, ff 0, "
        f"prefix {len(eng.prefix_ids)} tokens); /parse {status}, /health ok")
    out["pp_backend"] = {"boot_s": boot, "status": status}
    del parser, eng
    os.environ["BRAIN_PP"] = "2"
    try:
        brain.make_parser_from_env()
        fail_if(True, "parallel: BRAIN_PP=2 on one card booted")
    except ValueError as e:
        fail_if("BRAIN_PP=2 x BRAIN_TP=1" not in str(e), f"parallel: {e}")
    os.environ.pop("BRAIN_PP")
    try:
        PagedDecodeEngine(preset="tinyllama-1.1b", mesh=mesh, init_weights=False)
        fail_if(True, "parallel: a paged engine on a mesh was built")
    except ValueError as e:
        fail_if("ROADMAP.md Queue 1 item 8" not in str(e), f"parallel: {e}")
    _hf_env(BRAIN_BACKEND="engine:tinyllama-1.1b", BRAIN_QUANT="int8")
    report["parallel"] = out


STT_BATCH_SLOTS = 4
# the work items, one tick each: (kind, utterance key, seconds of synth audio)
STT_BATCH_ROUNDS = (
    (("final", 1, 2.0), ("final", 2, 5.5), ("final", 3, 9.8), ("final", 4, 1.2)),
    (("partial", 5, 1.6), ("partial", 6, 2.7), ("spec_final", 7, 3.3), ("final", 8, 0.8)),
    (("partial", 5, 3.1), ("partial", 6, 4.0), ("final", 9, 7.0)),
)
# the fp32 twin's: the round that holds every kind (a partial, a spec_final,
# a final), a depth the script's time limit sets
STT_BATCH_TWIN_ROUNDS = STT_BATCH_ROUNDS[1:2]


def _whisper_top2(eng, cross_kv: dict, enc_len: int, tokens: list[int]) -> dict:
    """The B = 1 decoder's two best next tokens after ``tokens``, teacher
    forced through the plain attention over ``cross_kv``: their margin and
    the best one's logit."""
    import torch

    from tpu_voice_agent_torch.models.whisper import decoder_forward, init_self_cache

    dev = eng.device
    seq = list(eng.bos_ids) + list(tokens)
    toks = torch.tensor([seq], dtype=torch.int32, device=dev)
    pos = torch.arange(len(seq), dtype=torch.int32, device=dev)[None]
    cache = init_self_cache(eng.cfg, 1, dtype=eng._param_dtype, device=dev)
    logits, _ = decoder_forward(eng.params, eng.cfg, toks, pos, cache, cross_kv,
                                torch.tensor([enc_len], dtype=torch.int32, device=dev),
                                attn_impl="torch")
    top = torch.topk(logits[0, -1].float(), 2)
    v, i = top.values.tolist(), top.indices.tolist()
    return {"top2": i, "margin": v[0] - v[1], "top_logit": v[0]}


def _stt_batch_items(eng, label: str, totals: dict, ulps: float,
                     rounds=STT_BATCH_ROUNDS) -> dict:
    """``rounds`` through ``STTBatcher(slots=4)``, one tick a round,
    each item against the B = 1 path on the same audio (``transcribe`` for
    a final or spec_final, an ``IncrementalState`` fed the same buffers for
    a partial): equal tokens, or a parting where the B = 1 decoder's plain
    top-2 margin is at most ``ulps`` bf16 ulps of its top logit."""
    import torch

    from tpu_voice_agent_torch.serve.stt_batch import STTBatcher
    from tpu_voice_agent_torch.voicebench import synth_utterance

    hop = eng.mel_cfg.hop
    batcher = STTBatcher(eng, slots=STT_BATCH_SLOTS, autostart=False)
    states: dict = {}
    items, diverged = 0, []
    b1_refs: list = []  # per round, per item: (kind, utt, B = 1 token ids, cross-KV, valid)
    b1_ms = tick_ms = 0.0
    for rnd in rounds:
        work = [(kind, utt, synth_utterance(sec)) for kind, utt, sec in rnd]
        refs = []
        for kind, utt, audio in work:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "partial":
                st = states.get(utt) or eng.incremental_init(len(audio) // hop)
                st = states[utt] = eng.incremental_feed(st, audio)
                res = eng.incremental_decode(st)
            else:
                res = eng.transcribe(audio)
            torch.cuda.synchronize()
            b1_ms += (time.perf_counter() - t0) * 1e3
            refs.append(res.token_ids)
        b1_refs.append([(kind, utt, ids, {"k": states[utt].cross_k, "v": states[utt].cross_v}
                         if kind == "partial" else None,
                         states[utt].enc_len if kind == "partial" else None)
                        for (kind, utt, _), ids in zip(work, refs)])
        with Counted(label, totals) as c:
            futs = [batcher.submit(kind, utt, audio) for kind, utt, audio in work]
            t0 = time.perf_counter()
            fail_if(batcher.tick() != len(work), f"{label}: a tick took another batch")
            torch.cuda.synchronize()
            tick_ms += (time.perf_counter() - t0) * 1e3
        c.require("decode_attention", "flash_attention")
        for (kind, utt, audio), fut, ref_ids in zip(work, futs, refs):
            got = fut.result(timeout=5)
            fail_if(got is None, f"{label}: the {kind} of utterance {utt} returned nothing")
            items += 1
            if got.token_ids == ref_ids:
                continue
            if kind == "partial":  # the B = 1 decode's own cross-KV
                ckv, n = {"k": states[utt].cross_k, "v": states[utt].cross_v}, states[utt].enc_len
            else:
                ckv, n, _ = eng._encode_window(audio)
            i = next((j for j, (x, y) in enumerate(zip(got.token_ids, ref_ids)) if x != y),
                     min(len(got.token_ids), len(ref_ids)))
            d = {"kind": kind, "step": i, **_whisper_top2(eng, ckv, n, ref_ids[:i])}
            diverged.append(d)
            log(f"[{label}] the {kind} of utterance {utt} parts from B = 1 at step {i}: top-2 "
                f"{d['top2']}, margin {d['margin']:.6f} against {d['top_logit']:.4f} "
                f"({_ulps(d):.2f} bf16 ulps)")
    _check_partings(diverged, label, ulps)
    log(f"[{label}] {items - len(diverged)}/{items} items equal to B = 1 over "
        f"{len(rounds)} ticks; B = 1 {b1_ms:.1f} ms, batched ticks {tick_ms:.1f} ms")
    return {"items": items, "equal": items - len(diverged),
            "partings_ulps": [round(_ulps(d), 3) for d in diverged],
            "b1_ms": b1_ms, "ticks_ms": tick_ms, "slots_after": batcher.slot_of,
            "b1_refs": b1_refs}


STT_REPLICAS = 2  # the replica drill's tier: 2 batchers of STT_BATCH_SLOTS over one engine
# CHAOS_HANG_S of the hang drill: the worker must still sleep when the tier
# restarts it, after the other replica's work is done (2.4 s on a slow host)
# and the stall limit has passed
STT_REPLICA_HANG_S = "6"
STT_REPLICA_STALL_S = 0.5  # the hang drill's stalled-tick limit


def _tier_round(tier, work: list) -> list:
    """One round of ``(kind, utt, audio)`` through ``tier``, submitted with
    every replica's worker held off its queue, so each takes its whole
    share as one batch (the same batches every run): the results, or the
    exception an item failed with."""
    import contextlib

    with contextlib.ExitStack() as held:
        for b in list(tier.batchers.values()):
            held.enter_context(b._wake)
        futs = [tier.submit(kind, utt, audio) for kind, utt, audio in work]
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=300))
        except Exception as e:  # noqa: BLE001 - a lost partial, reported by the caller
            out.append(e)
    return out


def _stt_tier_check(eng, work: list, b1_refs: list, results: list, label: str, ulps: float,
                    finals_only: bool) -> dict:
    """Each delivered item against its B = 1 tokens: equal, or parted where
    the B = 1 decoder's plain top-2 margin is within ``ulps``. Every final
    must be delivered (``finals_only``: the only kind checked)."""
    from tpu_voice_agent_torch.serve.stt import TranscribeResult

    checked, diverged, lost = 0, [], []
    for rnd, (items, refs, got) in enumerate(zip(work, b1_refs, results)):
        for (kind, utt, audio), (_, _, ref_ids, ckv, n), res in zip(items, refs, got):
            if finals_only and kind != "final":
                continue
            if not isinstance(res, TranscribeResult):
                lost.append((kind, utt, repr(res)[:80]))
                continue
            checked += 1
            if res.token_ids == ref_ids:
                continue
            if ckv is None:
                ckv, n, _ = eng._encode_window(audio)
            i = next((j for j, (x, y) in enumerate(zip(res.token_ids, ref_ids)) if x != y),
                     min(len(res.token_ids), len(ref_ids)))
            d = {"kind": kind, "utt": utt, "step": i,
                 **_whisper_top2(eng, ckv, n, ref_ids[:i])}
            diverged.append(d)
            log(f"[{label}] the {kind} of utterance {utt} parts from B = 1 at step {i} "
                f"({_ulps(d):.2f} bf16 ulps)")
    fail_if(lost, f"{label}: items lost {lost}")
    _check_partings(diverged, label, ulps)
    return {"checked": checked, "equal": checked - len(diverged),
            "partings_ulps": [round(_ulps(d), 3) for d in diverged]}


def _stt_replica_drill(eng, b1_refs: list, totals: dict, ulps: float) -> dict:
    """``STTReplicaTier(replicas=2, slots=4)`` over the phase's engine on its
    11 items, round by round: clean (every item equal to B = 1 or parted
    within ``ulps``), then with ``stt_replica_kill@1`` (no final lost, the
    finals equal again, two watchdog sweeps: ``stt.replica_restarts`` 1),
    then one ``stt_replica_hang@1`` drill: the stalled-tick verdict
    warm-restarts the hung replica, its finals fail over, the hung worker
    launches nothing, and round 1 on the restarted tier is bit-equal to the
    clean run's."""
    from tpu_voice_agent_torch.ops import _lib
    from tpu_voice_agent_torch.serve.stt_replicas import STTReplicaTier
    from tpu_voice_agent_torch.utils import chaos
    from tpu_voice_agent_torch.utils.tracing import get_metrics
    from tpu_voice_agent_torch.voicebench import synth_utterance

    def restarts():
        return get_metrics().snapshot()["counters"].get("stt.replica_restarts", 0.0)

    def tier(stall_s: float = 3600.0):
        return STTReplicaTier(eng, replicas=STT_REPLICAS, slots=STT_BATCH_SLOTS, probe_s=3600.0,
                              stall_s=stall_s, register=False)

    work = [[(kind, utt, synth_utterance(sec)) for kind, utt, sec in rnd]
            for rnd in STT_BATCH_ROUNDS]
    out = {}
    clean_round1 = None
    for mode in ("clean", "kill"):
        t = tier()
        r0 = restarts()
        try:
            if mode == "kill":
                chaos.configure("stt_replica_kill@1", seed=0)
            t0 = time.perf_counter()
            with Counted(f"stt replicas {mode}", totals) as c:
                results = [_tier_round(t, rnd) for rnd in work]
                if mode == "kill":
                    t.sweep_once()
                    t.sweep_once()  # ejected after 2 failed sweeps, warm-restarted
                    t.sweep_once()  # and re-admitted
            wall = time.perf_counter() - t0
            dead = [r.url for r in t.replicas if not t.batchers[r.idx].healthy()]
            health = t.tier_health()
        finally:
            chaos.reset()
            t.stop()
        c.require("decode_attention", "flash_attention")
        row = _stt_tier_check(eng, work, b1_refs, results, f"stt replicas {mode}", ulps,
                              finals_only=mode == "kill")
        row.update(wall_s=wall, restarts=restarts() - r0, launches=c.counts, health=health,
                   lost_best_effort=sum(not hasattr(x, "token_ids") for rnd in results
                                        for x in rnd))
        if mode == "clean":
            clean_round1 = [x.token_ids for x in results[0]]
            fail_if(row["restarts"] != 0, f"stt replicas clean: {row['restarts']} restarts")
        else:
            fail_if(row["restarts"] != 1 or dead or health["healthy"] != STT_REPLICAS,
                    f"stt replicas kill: {row['restarts']} restarts, dead {dead}, {health}")
        out[mode] = row
        log(f"[stt replicas {mode}] {STT_REPLICAS} x {STT_BATCH_SLOTS} slots, "
            f"{len(STT_BATCH_ROUNDS)} rounds: {row['equal']}/{row['checked']} "
            f"{'finals' if mode == 'kill' else 'items'} equal to B = 1, "
            f"{row['lost_best_effort']} best-effort items lost, {row['restarts']:.0f} restarts, "
            f"{wall:.2f} s")
    # the hang drill, with every kernel call's thread recorded
    t = tier(STT_REPLICA_STALL_S)
    real_lib = _lib.library()
    spy = _LaunchLog(real_lib)
    os.environ["CHAOS_HANG_S"] = STT_REPLICA_HANG_S
    r0 = restarts()
    try:
        _lib._LIB = spy
        chaos.configure("stt_replica_hang@1", seed=0)
        t0 = time.perf_counter()
        with Counted("stt replicas hang", totals) as c:
            import contextlib

            with contextlib.ExitStack() as held:
                for b in list(t.batchers.values()):
                    held.enter_context(b._wake)
                futs = [t.submit(kind, utt, audio) for kind, utt, audio in work[0]]
            give_up = time.monotonic() + 120
            hung = None
            while hung is None and time.monotonic() < give_up:
                busy = [(r, t.batchers[r.idx]) for r in t.replicas if t.batchers[r.idx]._busy
                        and any(not w.future.done() for w in t.batchers[r.idx]._inflight)]
                others_done = all(f.done() for f, (_, utt, _) in zip(futs, work[0])
                                  if not any(w.utt == utt for _, b in busy for w in b._inflight))
                if len(busy) == 1 and others_done:
                    hung = busy[0]
                time.sleep(0.01)
            fail_if(hung is None, "stt replicas hang: no replica hung")
            hung_replica, old = hung
            old_thread = old._thread
            t.sweep_once()  # the stalled verdict's baseline
            time.sleep(STT_REPLICA_STALL_S + 0.1)
            # two stalled sweeps eject and warm-restart the hung replica (one
            # more when its stall clock, which runs from the tier's start,
            # had not run out at the baseline); no sweep after the restart,
            # which would judge the replica its finals fail over to by the
            # idle reading of the sweep before
            for _ in range(2):
                t.sweep_once()
                if restarts() - r0:
                    break
            t_restart = time.monotonic()
            hung_results = [f.result(timeout=300) for f in futs]
            old_thread.join(timeout=float(STT_REPLICA_HANG_S) + 60)
            fail_if(old_thread.is_alive(), "stt replicas hang: the hung worker never exited")
            fresh = t.batchers[hung_replica.idx]
            t.sweep_once()  # the restarted replica re-admits
            chaos.reset()
            for _, utt, _ in work[0]:
                t.release(utt)  # re-placed by rendezvous: the clean run's batches
            again = _tier_round(t, work[0])
        wall = time.perf_counter() - t0
    finally:
        chaos.reset()
        os.environ.pop("CHAOS_HANG_S", None)
        _lib._LIB = real_lib
        t.stop()
    from_hung = [(k, ts - t_restart) for th, ts, k in spy.calls if th is old_thread]
    fail_if(any(dt < 0 for _, dt in from_hung),
            f"stt replicas hang: the worker woke from its {STT_REPLICA_HANG_S} s hang before "
            f"the restart and launched {from_hung[:4]} (s from the restart)")
    fail_if(from_hung, f"stt replicas hang: the hung worker launched {from_hung[:4]}")
    fail_if(restarts() - r0 != 1, f"stt replicas hang: {restarts() - r0} restarts")
    fail_if(fresh is old or fresh.pool["k"].data_ptr() == old.pool["k"].data_ptr(),
            "stt replicas hang: the restart kept the hung batcher's pool")
    hung_row = _stt_tier_check(eng, [work[0]], [b1_refs[0]], [hung_results],
                               "stt replicas hang", ulps, finals_only=True)
    fail_if([getattr(x, "token_ids", None) for x in again] != clean_round1,
            "stt replicas hang: round 1 on the restarted tier is not the clean run's bits")
    fresh_calls = spy.by_kernel({fresh._thread})
    fail_if(not fresh_calls.get("decode_attention"),
            f"stt replicas hang: the fresh batcher launched no K5 ({fresh_calls})")
    out["hang"] = {**hung_row, "wall_s": wall, "launches_from_hung_worker": len(from_hung),
                   "fresh_batcher_kernel_calls": fresh_calls, "round1_bit_equal": True,
                   "hang_s": float(STT_REPLICA_HANG_S), "stall_s": STT_REPLICA_STALL_S,
                   "launches": c.counts}
    log(f"[stt replicas hang] the hung replica warm-restarted ({STT_REPLICA_STALL_S} s stall "
        f"limit, {STT_REPLICA_HANG_S} s hang): its finals failed over "
        f"({hung_row['equal']}/{hung_row['checked']} equal to B = 1), 0 launches from the hung "
        f"worker, the fresh batcher's calls {fresh_calls}, round 1 bit-equal to the clean run; "
        f"{wall:.2f} s")
    return out


def _stt_batch_service(totals: dict) -> dict:
    """One paced utterance (synth_utterance(2.0) + 1 s of silence)
    through the voice service at VOICE_STT=whisper:whisper-large-v3
    (SpeechEngine's defaults) behind the rule brain and a stub executor,
    ``STT_BATCH_ENABLE=1``, on 3 connections at once (each the same
    audio, so a one-connection run would repeat one of them). The drain
    after the last frame, partials, coalesced and shed partials; every
    final has its intent and no frame is an error. (The locked plane's run
    of the same paced audio is the voice_service phase's.)"""
    import numpy as np

    from tpu_voice_agent_torch import voicebench
    from tpu_voice_agent_torch.services import brain, voice, ws
    from tpu_voice_agent_torch.utils.tracing import get_metrics

    def counters():
        snap = get_metrics().snapshot()["counters"]
        return {k: snap.get(k, 0.0) for k in ("stt.partials_coalesced", "stt.shed_overload",
                                               "stt.batch_ticks", "stt.finals_batched")}

    sil = np.zeros(16_000, dtype=np.float32)
    audio = np.concatenate([x for _ in range(VOICE_AUDIO_UTTERANCES)
                            for x in (voicebench.synth_utterance(2.0), sil)])
    frames = _pcm_frames(audio)
    bsrv, bthread, brain_url = _serve_brain(brain.BrainApp(brain.RuleBasedParser()))
    xsrv, xthread, exec_url, _received = _stub_executor()
    os.environ["VOICE_STT"] = "whisper:whisper-large-v3"
    out = {}
    mode, n_conn = "batched x3", 3
    try:
        os.environ["STT_BATCH_ENABLE"] = "1"
        os.environ["STT_BATCH_SLOTS"] = str(STT_BATCH_SLOTS)
        cfg = voice.VoiceConfig(brain_url=brain_url, executor_url=exec_url)
        probe = cfg.stt_factory()
        fail_if(probe.engine.device.type != "cuda", f"stt_batch {mode}: STT not on the card")
        fail_if(not hasattr(probe, "batcher"),
                f"stt_batch {mode}: the wrong STT plane ({type(probe).__name__})")
        srv = ws.ServerThread(voice.build_app(cfg)).__enter__()
        c0 = counters()

        async def run_all(url=srv.url):
            return await asyncio.gather(*[_stream_paced(url, frames)
                                          for _ in range(n_conn)])

        try:
            with Counted(f"stt_batch service {mode}", totals) as c:
                runs = asyncio.run(run_all())
        finally:
            srv.__exit__(None, None, None)
            if hasattr(probe, "batcher"):
                probe.batcher.stop()
        c.require("decode_attention", "flash_attention")
        finals = 0
        for res in runs:
            _check_vocabulary(res["events"], f"stt_batch {mode}")
            _check_finals(res["events"], f"stt_batch {mode}")
            finals += sum(e["type"] == "transcript_final" for e in res["events"])
        d = {k: v - c0[k] for k, v in counters().items()}
        out[mode] = {
            "connections": n_conn, "finals": finals,
            "partials": sum(e["type"] == "transcript_partial"
                            for res in runs for e in res["events"]),
            "drained_after_audio_s": max(res["drained_s"] for res in runs),
            "audio_s": max(res["audio_s"] for res in runs),
            "partials_coalesced": d["stt.partials_coalesced"],
            "shed_overload": d["stt.shed_overload"], "batch_ticks": d["stt.batch_ticks"],
            "finals_batched": d["stt.finals_batched"], "launches": c.counts}
        log(f"[stt_batch] service, {mode}: {n_conn} connection(s) x "
            f"{VOICE_AUDIO_UTTERANCES} paced utterances: {finals} finals, "
            f"{out[mode]['partials']} partials, drained "
            f"{out[mode]['drained_after_audio_s']:.2f} s after the last frame; coalesced "
            f"{d['stt.partials_coalesced']:.0f}, shed {d['stt.shed_overload']:.0f}, "
            f"{d['stt.batch_ticks']:.0f} ticks")
        del probe
        _free_cuda()
    finally:
        for k in ("VOICE_STT", "STT_BATCH_ENABLE", "STT_BATCH_SLOTS"):
            os.environ.pop(k, None)
        _stop(bsrv, bthread)
        _stop(xsrv, xthread)
    return out


def phase_stt_batch(totals: dict, report: dict) -> None:
    """The batched STT plane (``serve/stt_batch.py``) on whisper-large-v3 at
    bench.py's shape (buckets 300 and 1000, 32 new tokens), bf16 random
    weights, ``STT_BATCH_SLOTS`` = 4: every work kind (ragged finals, a
    spec_final, partials over persistent pool slots) against the B = 1 path
    (``_stt_batch_items``; K5 at B = 4 with ragged kv_len), held to
    ``BF16_PART_ULPS`` in bf16 and to one ulp in a twin on fp32 copies of
    the weights (``STT_BATCH_TWIN_ROUNDS``); then the voice service's paced
    audio on the batched plane
    (``_stt_batch_service``)."""
    import torch

    from tpu_voice_agent_torch.serve.stt import SpeechEngine

    out = {}
    t0 = time.perf_counter()
    eng = SpeechEngine("whisper-large-v3", frame_buckets=(300, 1000), max_new_tokens=32)
    log(f"[stt_batch] boot {time.perf_counter() - t0:.2f} s")
    out["bf16"] = _stt_batch_items(eng, "stt_batch bf16", totals, BF16_PART_ULPS)
    t0 = time.perf_counter()
    out["replicas"] = _stt_replica_drill(eng, out["bf16"].pop("b1_refs"), totals,
                                         BF16_PART_ULPS)
    log(f"[stt_batch] replica drill {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    eng.load_params(_to_float(eng.params))
    out["fp32"] = _stt_batch_items(eng, "stt_batch fp32", totals, 1, STT_BATCH_TWIN_ROUNDS)
    out["fp32"].pop("b1_refs")
    del eng
    _free_cuda()
    out["service"] = _stt_batch_service(totals)
    report["stt_batch"] = out


# ---------------------------------------------------------------- hf_import

# published config.json widths (HF's TinyLlama/TinyLlama-1.1B-Chat-v1.0,
# mistralai/Mixtral-8x7B-v0.1 and openai/whisper-large-v3)
HF_TINYLLAMA = {"architectures": ["LlamaForCausalLM"], "vocab_size": 32000,
                "hidden_size": 2048, "num_hidden_layers": 22, "num_attention_heads": 32,
                "num_key_value_heads": 4, "intermediate_size": 5632,
                "max_position_embeddings": 2048, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
                "tie_word_embeddings": False}
HF_MIXTRAL_LAYERS = 1  # of 32: the cut the script's time limit sets
HF_MIXTRAL = {"architectures": ["MixtralForCausalLM"], "vocab_size": 32000,
              "hidden_size": 4096, "num_hidden_layers": HF_MIXTRAL_LAYERS,
              "num_attention_heads": 32, "num_key_value_heads": 8, "intermediate_size": 14336,
              "max_position_embeddings": 32768, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
              "num_local_experts": 8, "num_experts_per_tok": 2, "tie_word_embeddings": False}
HF_WHISPER = {"architectures": ["WhisperForConditionalGeneration"], "vocab_size": 51866,
              "d_model": 1280, "encoder_layers": 32, "decoder_layers": 32,
              "encoder_attention_heads": 20, "decoder_attention_heads": 20,
              "encoder_ffn_dim": 5120, "decoder_ffn_dim": 5120, "num_mel_bins": 128,
              "max_source_positions": 1500, "max_target_positions": 448}
# the seeded trees carry one structured component: a constant 100 on channel
# 0 of every embedding row and +0.5 on that channel of the head's columns for
# EOS and the pieces that open with '"', '{' or '}'. The residual stream
# keeps the constant, so a random model prefers, wherever the grammar allows,
# to open an object (so ``intents`` is not empty) and to close strings and
# objects: it reaches EOS inside the parser's 512 tokens, and every /parse
# can answer 200 with an intent that parses
HF_BIAS_CHANNEL, HF_BIAS_HEAD = 100.0, 0.5
SP = "▁"
HF_DEVICE = "cuda"  # where the seeded trees are drawn and loaded
HF_PARSES = 1  # of the 5 utterances: a depth the script's time limit sets
HF_TWIN_NEW_TOKENS = 64  # the fp32 twin's budget: a depth the script's time limit sets


def _sp_tokenizer_json(vocab_size: int = 32000, seed: int = 0) -> dict:
    """A TinyLlama-style (SentencePiece BPE) tokenizer.json: ``<unk> <s>
    </s>``, 256 ``<0xNN>`` byte pieces, the corpus's characters, merges
    trained on the prompt corpus's ▁-words, then seeded filler pieces to
    ``vocab_size``, with the Prepend / Replace normalizer."""
    import random
    from collections import Counter

    from tpu_voice_agent_torch.services.prompts import corpus_for_tokenizer

    words: Counter = Counter()
    for text in corpus_for_tokenizer():
        for w in (SP + text.replace(" ", SP)).split(SP):
            if w:
                words[tuple(SP + w)] += 1
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for w in words:
        for ch in w:
            vocab.setdefault(ch, len(vocab))
    merges, work = [], dict(words)
    while len(vocab) < vocab_size:
        pairs: Counter = Counter()
        for w, c in work.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs or pairs.most_common(1)[0][1] < 2:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        new: dict = {}
        for w, c in work.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] = new.get(tuple(out), 0) + c
        work = new
    rng = random.Random(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(vocab) < vocab_size:
        piece = (SP if rng.random() < 0.6 else "") + "".join(
            rng.choice(letters) for _ in range(rng.randint(2, 9)))
        vocab.setdefault(piece, len(vocab))
    return {"model": {"type": "BPE", "vocab": vocab, "byte_fallback": True,
                      "merges": [f"{a} {b}" for a, b in merges]},
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "Prepend", "prepend": SP},
                {"type": "Replace", "pattern": {"String": " "}, "content": SP}]},
            "added_tokens": [{"id": i, "content": c, "special": True}
                             for i, c in enumerate(("<unk>", "<s>", "</s>"))]}


def _whisper_tokenizer_json(seed: int = 1) -> dict:
    """A whisper-large-v3-layout (byte-level BPE) tokenizer.json: 256 byte
    symbols, merges trained on the prompt corpus, seeded filler to 50,257
    ids, then Whisper's 1,609 control tokens (ids 50,257-51,865:
    ``<|endoftext|>``, ``<|startoftranscript|>``, 100 languages,
    translate / transcribe, startoflm / startofprev / nospeech,
    ``<|notimestamps|>``, the 1,501 timestamps)."""
    import random
    from collections import Counter

    from tpu_voice_agent_torch.grammar.hf_tokenizer import _PRETOK, _byte_to_unicode
    from tpu_voice_agent_torch.services.prompts import corpus_for_tokenizer

    b2u = _byte_to_unicode()
    words: Counter = Counter()
    for text in corpus_for_tokenizer():
        for m in _PRETOK.finditer(text):
            words[tuple(b2u[b] for b in m.group(0).encode())] += 1
    vocab = {b2u[b]: b for b in range(256)}
    merges, work = [], dict(words)
    for _ in range(2000):
        pairs: Counter = Counter()
        for w, c in work.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs or pairs.most_common(1)[0][1] < 2:
            break
        (a, b), _ = pairs.most_common(1)[0]
        merges.append((a, b))
        vocab.setdefault(a + b, len(vocab))
        new: dict = {}
        for w, c in work.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] = new.get(tuple(out), 0) + c
        work = new
    rng = random.Random(seed)
    letters = "abcdefghijklmnopqrstuvwxyz"
    while len(vocab) < 50257:
        piece = ("Ġ" if rng.random() < 0.6 else "") + "".join(
            rng.choice(letters) for _ in range(rng.randint(2, 9)))
        vocab.setdefault(piece, len(vocab))
    specials = (["<|endoftext|>", "<|startoftranscript|>", "<|en|>"]
                + [f"<|lang{i}|>" for i in range(99)]
                + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
                   "<|nospeech|>", "<|notimestamps|>"]
                + [f"<|{0.02 * i:.2f}|>" for i in range(1501)])
    return {"model": {"type": "BPE", "vocab": vocab,
                      "merges": [f"{a} {b}" for a, b in merges]},
            "pre_tokenizer": {"type": "ByteLevel"},
            "added_tokens": [{"id": 50257 + i, "content": c, "special": True}
                             for i, c in enumerate(specials)]}


def _write_safetensors(path: str, tensors: dict) -> int:
    """A safetensors file written here (not with the ``safetensors``
    package): the 8-byte little-endian header length, the JSON header padded
    with spaces to 8 bytes, then each tensor's bytes in header order.
    Returns the data bytes."""
    import torch

    tags = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    header, off, cpu = {}, 0, {}
    for name, t in tensors.items():
        c = t.detach().to("cpu").contiguous()
        cpu[name] = c
        n = c.numel() * c.element_size()
        header[name] = {"dtype": tags[c.dtype], "shape": list(c.shape),
                        "data_offsets": [off, off + n]}
        off += n
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for c in cpu.values():
            f.write(c.reshape(-1).view(torch.uint8).numpy().tobytes())
    return off


def _write_hf_dir(d: str, config: dict, tokenizer: dict, state: dict, shards: int) -> dict:
    """config.json, tokenizer.json and ``state`` in ``shards`` files of
    about equal bytes (``model-0000k-of-0000n.safetensors``). Returns the
    write's bytes and seconds."""
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(tokenizer, f)
    total = sum(t.numel() * t.element_size() for t in state.values())
    parts: list[dict] = [{} for _ in range(shards)]
    acc = 0
    for name, t in state.items():
        parts[min(shards - 1, acc * shards // max(total, 1))][name] = t
        acc += t.numel() * t.element_size()
    nbytes = sum(_write_safetensors(os.path.join(d, f"model-{k + 1:05d}-of-{shards:05d}"
                                                    ".safetensors"), p)
                 for k, p in enumerate(parts))
    return {"bytes": nbytes, "write_s": time.perf_counter() - t0}


def _hf_llama_state(tree: dict, cfg) -> dict:
    """The port's stacked Llama / Mixtral tree -> HF names in (out, in)
    layout (views on the card; the writer copies them out)."""
    L, layers = cfg.n_layers, tree["layers"]
    state = {"model.embed_tokens.weight": tree["embed"], "model.norm.weight": tree["final_norm"],
             "lm_head.weight": tree["lm_head"].t()}
    for i in range(L):
        p = f"model.layers.{i}."
        state[p + "input_layernorm.weight"] = layers["attn_norm"][i]
        state[p + "post_attention_layernorm.weight"] = layers["mlp_norm"][i]
        for ours, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                         ("wo", "o_proj")):
            state[p + f"self_attn.{hf}.weight"] = layers[ours][i].t()
        if cfg.n_experts:
            state[p + "block_sparse_moe.gate.weight"] = layers["router"][i].t()
            for e in range(cfg.n_experts):
                q = f"{p}block_sparse_moe.experts.{e}."
                state[q + "w1.weight"] = layers["moe_gate"][i, e].t()
                state[q + "w3.weight"] = layers["moe_up"][i, e].t()
                state[q + "w2.weight"] = layers["moe_down"][i, e].t()
        else:
            for ours, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
                state[p + f"mlp.{hf}.weight"] = layers[ours][i].t()
    return state


def _hf_whisper_state(tree: dict, cfg) -> dict:
    """The port's Whisper tree -> HF names: linear (in, out) -> (out, in),
    conv (k, in, out) -> (out, in, k), no k bias; ``proj_out`` written tied
    (HF ships it; the import does not read it)."""
    enc, dec = tree["encoder"], tree["decoder"]
    state = {"model.encoder.conv1.weight": enc["conv1"]["w"].permute(2, 1, 0),
             "model.encoder.conv1.bias": enc["conv1"]["b"],
             "model.encoder.conv2.weight": enc["conv2"]["w"].permute(2, 1, 0),
             "model.encoder.conv2.bias": enc["conv2"]["b"],
             "model.encoder.layer_norm.weight": enc["ln_post"]["g"],
             "model.encoder.layer_norm.bias": enc["ln_post"]["b"],
             "model.decoder.embed_tokens.weight": dec["tok_emb"],
             "model.decoder.embed_positions.weight": dec["pos_emb"],
             "model.decoder.layer_norm.weight": dec["ln_final"]["g"],
             "model.decoder.layer_norm.bias": dec["ln_final"]["b"],
             "proj_out.weight": dec["tok_emb"]}

    def attn(p, a, i):
        for ours, hf in (("wq", "q"), ("wk", "k"), ("wv", "v"), ("wo", "out")):
            state[f"{p}.{hf}_proj.weight"] = a[ours][i].t()
        for ours, hf in (("bq", "q"), ("bv", "v"), ("bo", "out")):
            state[f"{p}.{hf}_proj.bias"] = a[ours][i]

    def rest(p, lay, i, lns):
        for ours, hf in lns:
            state[f"{p}.{hf}.weight"], state[f"{p}.{hf}.bias"] = lay[ours]["g"][i], lay[ours]["b"][i]
        state[p + ".fc1.weight"], state[p + ".fc1.bias"] = lay["w1"][i].t(), lay["b1"][i]
        state[p + ".fc2.weight"], state[p + ".fc2.bias"] = lay["w2"][i].t(), lay["b2"][i]

    for i in range(cfg.enc_layers):
        p, lay = f"model.encoder.layers.{i}", enc["layers"]
        attn(p + ".self_attn", lay["attn"], i)
        rest(p, lay, i, (("ln1", "self_attn_layer_norm"), ("ln2", "final_layer_norm")))
    for i in range(cfg.dec_layers):
        p, lay = f"model.decoder.layers.{i}", dec["layers"]
        attn(p + ".self_attn", lay["self_attn"], i)
        attn(p + ".encoder_attn", lay["cross_attn"], i)
        rest(p, lay, i, (("ln1", "self_attn_layer_norm"), ("ln2", "encoder_attn_layer_norm"),
                         ("ln3", "final_layer_norm")))
    return state


def _bias_tree(tree: dict, tok) -> None:
    """The closing-piece preference (``HF_BIAS_*``), in place."""
    closing = [tok.eos_id] + [i for i, p in enumerate(tok.byte_pieces())
                              if p and p[:1] in (b'"', b"{", b"}")]
    tree["embed"][:, 0] += HF_BIAS_CHANNEL
    tree["lm_head"][0, closing] += HF_BIAS_HEAD


def _flat_equal(a, b, path: str = "") -> list:
    """Leaf paths where two trees differ (dtype, shape or any bit)."""
    import torch

    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [path or "<root>"]
        return [p for k in a for p in _flat_equal(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, list):
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in _flat_equal(x, y, f"{path}[{i}]")]
    ok = a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return [] if ok else [path]


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _hf_env(**env) -> None:
    for k in ("BRAIN_BACKEND", "BRAIN_MODEL", "BRAIN_QUANT", "BRAIN_MOE", "BRAIN_FF",
              "BRAIN_PREFIX", "BRAIN_DEVICE", "BRAIN_BATCH", "BRAIN_PAGED", "BRAIN_POOL_BLOCKS",
              "RADIX_ENABLE", "KV_QUANT", "SPEC_ENABLE", "VOICE_STT", "VOICE_DEVICE",
              "STT_BATCH_ENABLE", "STT_REPLICAS", "CHAOS_FAULTS"):
        os.environ.pop(k, None)
    os.environ.update(env)


def _hf_parses(parser, texts, label: str) -> list:
    """POST each text to /parse on a BrainApp over ``parser``: every answer
    must be 200 with a ParseResponse holding an intent. Returns the token
    ids of each decode (single-slot parsers), or []."""
    from tpu_voice_agent_torch.schemas import validate_parse_response
    from tpu_voice_agent_torch.services import brain

    server, thread, base = _serve_brain(brain.BrainApp(parser))
    ids = []
    try:
        for text in texts:
            t1 = time.perf_counter()
            status, body = _post(base, {"text": text, "context": {}})
            wall = (time.perf_counter() - t1) * 1e3
            fail_if(status != 200 or validate_parse_response(body) != (body, None)
                    or not body.get("intents"),
                    f"{label}: /parse {text!r} answered {status} {str(body)[:300]}")
            res = getattr(parser, "last_result", None)
            if res is not None:
                ids.append(list(res.token_ids))
            log(f"[{label}] /parse {text!r}: 200 {[i['type'] for i in body['intents']]} "
                f"({len(json.dumps(body))} JSON bytes) wall {wall:.1f} ms" + (f", {res.steps} tokens, {res.forwards} forwards, "
                                         f"prompt {res.prompt_tokens} (cached "
                                         f"{res.cached_tokens})" if res is not None else ""))
    finally:
        _stop(server, thread)
    return ids


def _no_dense_mask(eng, c: Counted, label: str) -> dict:
    """At a checkpoint vocab the intent FSM has no dense mask (S·V past
    ``device_tables``' 2^25 limit), so K4 / K11 are not launched and the
    greedy picks take the compressed two-gather row in torch, as in JAX."""
    S, V = eng.fsm.num_states, eng.cfg.vocab_size
    k4 = c.counts.get("masked_argmax_advance", 0)
    k11 = c.counts.get("masked_argmax", 0)
    log(f"[{label}] K4 / K11 not on this path: S {S} x V {V} = {S * V:,} > 2^25 = "
        f"{1 << 25:,}, so no dense mask (device_tables); masked_argmax_advance launches {k4}, "
        f"masked_argmax {k11}; picks take the compressed table[state][col_id] row")
    fail_if(eng.tables.dense_mask is not None or S * V <= 1 << 25,
            f"{label}: a dense mask at a checkpoint vocab")
    fail_if(k4 or k11, f"{label}: K4 / K11 launched without a dense mask")
    return {"S": S, "V": V, "SV": S * V, "dense_limit": 1 << 25, "k4": k4, "k11": k11}


def _hf_tinyllama(root: str, totals: dict, tok_json: dict) -> dict:
    """(a) a TinyLlama-1.1B directory, (b) the BRAIN_MODEL int8 brain on it,
    its tokens against engines given the tree directly (bf16 and an fp32
    twin), (c) the BRAIN_PAGED=1 BRAIN_BATCH=32 brain's drain."""
    from dataclasses import replace

    import torch

    from tpu_voice_agent_torch.ckpt.hf_import import llama_config_from_hf, llama_from_hf_state
    from tpu_voice_agent_torch.grammar.intent_grammar import build_fsm_for
    from tpu_voice_agent_torch.models.llama import init_params, quantize_params, stack_layers
    from tpu_voice_agent_torch.serve.engine import DecodeEngine, checkpoint_tokenizer
    from tpu_voice_agent_torch.services import brain
    from tpu_voice_agent_torch.services.prompts import render_prompt

    out: dict = {}
    d = os.path.join(root, "tinyllama-1.1b")
    os.makedirs(d)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(tok_json, f)
    t0 = time.perf_counter()
    tok = checkpoint_tokenizer(d)
    out["tokenizer_s"] = time.perf_counter() - t0
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(HF_TINYLLAMA, f)
    cfg = llama_config_from_hf(d)
    tree = init_params(cfg, torch.Generator(HF_DEVICE).manual_seed(20), device=HF_DEVICE)
    _bias_tree(tree, tok)
    out["write"] = _write_hf_dir(d, HF_TINYLLAMA, tok_json, _hf_llama_state(tree, cfg), 2)
    log(f"[hf_import] tinyllama-1.1b: {tok.kind} tokenizer of {tok.vocab_size} ids "
        f"(read in {out['tokenizer_s']:.2f} s), {out['write']['bytes'] / 1e9:.3f} GB of BF16 in 2 "
        f"shards written in {out['write']['write_s']:.2f} s")
    t0 = time.perf_counter()
    fsm = build_fsm_for(tok, vocab_size=cfg.vocab_size)
    out["fsm_build_s"] = time.perf_counter() - t0
    log(f"[hf_import] intent FSM over the checkpoint tokenizer: {fsm.num_states} states, "
        f"{fsm.num_classes} classes, V {fsm.vocab_size}, built in {out['fsm_build_s']:.2f} s "
        "(host)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = llama_from_hf_state(d, cfg, device=HF_DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    nbytes = _tree_bytes(loaded)
    out["load"] = {"bytes": nbytes, "s": load_s, "gb_per_s": nbytes / load_s / 1e9,
                   "page_cache": "warm (just written)"}
    bad = _flat_equal(loaded, tree)
    log(f"[hf_import] bf16 load {nbytes / 1e9:.3f} GB in {load_s:.3f} s = "
        f"{out['load']['gb_per_s']:.3f} GB/s (page cache warm); bit-equal to the seeded tree: "
        f"{not bad}")
    fail_if(bool(bad), f"hf_import: loaded tensors differ from the seeded tree: {bad[:5]}")
    del loaded

    # (b) the BRAIN_MODEL brain, int8 quantized per layer as read
    _hf_env(BRAIN_MODEL=d, BRAIN_QUANT="int8")
    with Counted("hf_import brain", totals) as c:
        t0 = time.perf_counter()
        parser = brain.make_parser_from_env()
        out["brain_boot_s"] = time.perf_counter() - t0
        eng = parser.engine
        fail_if(eng.device.type != HF_DEVICE or eng.quant != "int8" or eng.fast_forward != 8
                or not eng.prefix_ids or eng.tokenizer is not tok,
                "hf_import: the BRAIN_MODEL brain is not int8 / ff 8 / cached prefix on the card")
        ids = _hf_parses(parser, UTTERANCES[:HF_PARSES], "hf_import brain")
    c.require("flash_attention", "decode_block_attention_layer")
    out["brain"] = {"prefix_tokens": len(eng.prefix_ids), "launches": c.counts,
                    "tokens": [len(x) for x in ids], "grammar": _no_dense_mask(eng, c,
                                                                               "hf_import brain")}
    bad = _flat_equal({**eng.params, "layers": stack_layers(eng.params["layers"])},
                      quantize_params(tree))
    fail_if(bool(bad), f"hf_import: the int8 tree quantized per layer differs from "
                       f"quantize_params on the seeded tree: {bad[:5]}")
    log(f"[hf_import] brain boot {out['brain_boot_s']:.2f} s (FSM cached on the tokenizer), "
        f"prefix {len(eng.prefix_ids)} tokens; int8 tree == quantize_params(seeded tree)")

    # the same tokens from an engine given the tokenizer and the tree directly
    prompts = [render_prompt(t, {}) for t in UTTERANCES[:HF_PARSES]]
    direct = DecodeEngine(cfg=cfg, tokenizer=tok, fsm=fsm, quant="int8", fast_forward=8,
                          init_weights=False)
    direct.load_params(tree)
    brain.install_prompt_prefix(direct)
    fail_if([direct.generate(p, max_new_tokens=512).token_ids for p in prompts] != ids, "hf_import: the BRAIN_MODEL brain's tokens differ from an engine "
                        "given the same tokenizer and tree")
    del direct, parser, eng
    _free_cuda()
    twin = {}
    for label, make in (
            ("from_hf", lambda: DecodeEngine.from_hf(d, dtype=torch.float32, fast_forward=8)),
            ("direct", lambda: _f32_direct(cfg, tok, fsm, tree))):
        e = make()
        brain.install_prompt_prefix(e)
        twin[label] = [e.generate(p, max_new_tokens=HF_TWIN_NEW_TOKENS).token_ids
                       for p in prompts[:1]]
        del e
        _free_cuda()
    fail_if(twin["from_hf"] != twin["direct"],
            "hf_import: the fp32 twin's tokens differ between from_hf and the tree")
    out["tokens_equal"] = {"bf16_int8": len(ids), "fp32_twin": len(twin["direct"])}
    log(f"[hf_import] tokens equal to an engine given the tree: {len(ids)} bf16 int8 parses, "
        f"{len(twin['direct'])} fp32 twin parses ({[len(x) for x in twin['direct']]} tokens)")

    # (c) the paged brain on the same directory
    _hf_env(BRAIN_MODEL=d, BRAIN_QUANT="int8", BRAIN_PAGED="1", BRAIN_BATCH=str(BATCH_SLOTS))
    with Counted("hf_import paged boot", totals):
        parser = brain.make_parser_from_env()
    parser.close()  # its serving loop: the drain steps the engine itself
    eng = parser.engine
    fail_if(eng.batch_slots != BATCH_SLOTS or eng.device.type != HF_DEVICE or not eng.prefix_ids,
            "hf_import: the paged brain is not 32 slots on the card behind the prefix")
    # JAX builds this engine at ff 0: every step a T = 1 forward through K6
    fail_if(eng.fast_forward != 0, f"hf_import: the paged brain runs ff {eng.fast_forward}, "
            "not JAX's 0")
    row, _, c = _drain(eng, "hf_import paged drain", totals)
    c.require("paged_attention")
    _no_dense_mask(eng, c, "hf_import paged drain")
    out["paged_drain"] = row
    del parser, eng, tree
    _hf_env()
    _free_cuda()
    return out


def _f32_direct(cfg, tok, fsm, tree):
    from tpu_voice_agent_torch.serve.engine import DecodeEngine

    e = DecodeEngine(cfg=cfg, tokenizer=tok, fsm=fsm, fast_forward=8, init_weights=False)
    e.load_params(_to_float(tree))
    return e


def _hf_whisper(root: str, totals: dict) -> dict:
    """(d) a whisper-large-v3 directory behind VOICE_STT=whisper-hf:<dir>."""
    import numpy as np
    import torch

    from tpu_voice_agent_torch import voicebench
    from tpu_voice_agent_torch.ckpt.hf_import import whisper_config_from_hf, whisper_from_hf_state
    from tpu_voice_agent_torch.models.whisper import init_params
    from tpu_voice_agent_torch.serve.stt import SpeechEngine

    out: dict = {}
    d = os.path.join(root, "whisper-large-v3")
    os.makedirs(d)
    tok_json = _whisper_tokenizer_json()
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(HF_WHISPER, f)
    cfg = whisper_config_from_hf(d)
    tree = init_params(cfg, torch.Generator(HF_DEVICE).manual_seed(21), device=HF_DEVICE)
    out["write"] = _write_hf_dir(d, HF_WHISPER, tok_json, _hf_whisper_state(tree, cfg), 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = whisper_from_hf_state(d, cfg, device=HF_DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    nbytes = _tree_bytes(loaded)
    out["load"] = {"bytes": nbytes, "s": load_s, "gb_per_s": nbytes / load_s / 1e9,
                   "page_cache": "warm (just written)"}
    bad = _flat_equal(loaded, tree)
    log(f"[hf_import] whisper-large-v3: {out['write']['bytes'] / 1e9:.3f} GB of BF16 written in "
        f"{out['write']['write_s']:.2f} s; load {load_s:.3f} s = {out['load']['gb_per_s']:.3f} "
        f"GB/s (page cache warm); bit-equal to the seeded tree: {not bad}")
    fail_if(bool(bad), f"hf_import: whisper tensors differ from the seeded tree: {bad[:5]}")
    del loaded

    _hf_env(VOICE_STT=f"whisper-hf:{d}")
    xsrv, xthread, exec_url, _ = _stub_executor()
    from tpu_voice_agent_torch.services import brain

    bsrv, bthread, brain_url = _serve_brain(brain.BrainApp(brain.RuleBasedParser()))
    t0 = time.perf_counter()
    vsrv, stt = _voice_boot(brain_url, exec_url)
    out["voice_boot_s"] = time.perf_counter() - t0
    tok = stt.tokenizer
    fail_if(stt.cfg.n_mels != 128 or stt.cfg.vocab_size != 51866 or stt.suppress is None
            or len(stt.bos_ids) != 4, "hf_import: the whisper-hf engine is not large-v3's")
    audio = np.concatenate([voicebench.synth_utterance(2.0), np.zeros(16_000, np.float32)])
    try:
        with Counted("hf_import voice", totals) as c:
            res = asyncio.run(_stream_paced(vsrv.url, _pcm_frames(audio)))
    finally:
        vsrv.__exit__(None, None, None)
        _stop(bsrv, bthread)
        _stop(xsrv, xthread)
    c.require("flash_attention", "decode_attention")
    events = res["events"]
    _check_vocabulary(events, "hf_import voice")
    _check_finals(events, "hf_import voice")
    finals = [e["text"] for e in events if e["type"] == "transcript_final"]
    fail_if(not finals or any("<|" in t for t in finals),
            f"hf_import: voice finals {finals!r}")
    direct = SpeechEngine(cfg=cfg, tokenizer=tok, bos_ids=stt.bos_ids, init_weights=False)
    direct.load_params(tree)
    a = stt.transcribe(audio).token_ids
    b = direct.transcribe(audio).token_ids
    special = tok.special_ids - {tok.eos_id}
    fail_if(a != b, "hf_import: whisper-hf transcript tokens differ from an engine given the tree")
    fail_if(bool(set(a) & special), f"hf_import: a suppressed id was emitted: {a}")
    out["voice"] = {"finals": finals, "transcript_tokens": len(a), "launches": c.counts,
                    "audio_s": res["audio_s"], "drained_s": res["drained_s"]}
    log(f"[hf_import] voice whisper-hf: boot {out['voice_boot_s']:.2f} s, finals "
        f"{[f[:40] for f in finals]}; transcript {len(a)} tokens equal to an engine given the "
        f"tree, none of the {len(special)} suppressed ids")
    del direct, stt, tree
    _hf_env()
    _free_cuda()
    return out


def _hf_mixtral(root: str, totals: dict, tok_json: dict) -> dict:
    """(e) a mixtral-8x7b-layout directory cut to HF_MIXTRAL_LAYERS layers
    under BRAIN_MOE=grouped BRAIN_QUANT=int8."""
    import torch

    from tpu_voice_agent_torch.ckpt.hf_import import llama_config_from_hf
    from tpu_voice_agent_torch.models.llama import init_params
    from tpu_voice_agent_torch.serve.engine import checkpoint_tokenizer
    from tpu_voice_agent_torch.services import brain

    out: dict = {}
    d = os.path.join(root, "mixtral-8x7b")
    os.makedirs(d)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(tok_json, f)
    tok = checkpoint_tokenizer(d)  # tinyllama's object: its FSM is cached
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(HF_MIXTRAL, f)
    cfg = llama_config_from_hf(d)
    tree = init_params(cfg, torch.Generator(HF_DEVICE).manual_seed(22), device=HF_DEVICE)
    _bias_tree(tree, tok)
    out["write"] = _write_hf_dir(d, HF_MIXTRAL, tok_json, _hf_llama_state(tree, cfg), 4)
    del tree
    _free_cuda()
    log(f"[hf_import] mixtral-8x7b layout, {HF_MIXTRAL_LAYERS} of 32 layers: "
        f"{out['write']['bytes'] / 1e9:.3f} GB of BF16 in 4 shards written in "
        f"{out['write']['write_s']:.2f} s")
    _hf_env(BRAIN_MODEL=d, BRAIN_QUANT="int8", BRAIN_MOE="grouped")
    with Counted("hf_import mixtral", totals) as c:
        t0 = time.perf_counter()
        parser = brain.make_parser_from_env()
        out["boot_s"] = time.perf_counter() - t0
        eng = parser.engine
        fail_if(eng.cfg.n_experts != 8 or eng.cfg.moe_impl != "grouped" or eng.quant != "int8",
                "hf_import: the mixtral brain is not grouped int8")
        _hf_parses(parser, UTTERANCES[:2], "hf_import mixtral")
    c.require("grouped_matmul", "flash_attention")
    out["grammar"] = _no_dense_mask(eng, c, "hf_import mixtral")
    out["launches"] = c.counts
    log(f"[hf_import] mixtral boot {out['boot_s']:.2f} s (int8 per layer as read)")
    del parser, eng
    _hf_env()
    _free_cuda()
    return out


def phase_hf_import(totals: dict, report: dict) -> None:
    """Checkpoint import on the card: HF-layout directories written here from
    seeded trees at published widths into a temporary directory (deleted
    after), then BRAIN_MODEL and VOICE_STT=whisper-hf served from them."""
    import shutil
    import tempfile

    import torch

    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="hf_import_")
    out: dict = {}
    tok_json = _sp_tokenizer_json()
    try:
        out["tinyllama"] = _hf_tinyllama(root, totals, tok_json)
        shutil.rmtree(os.path.join(root, "tinyllama-1.1b"), ignore_errors=True)
        out["whisper"] = _hf_whisper(root, totals)
        shutil.rmtree(os.path.join(root, "whisper-large-v3"), ignore_errors=True)
        out["mixtral"] = _hf_mixtral(root, totals, tok_json)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t0
    log(f"[hf_import] load {out['tinyllama']['load']['gb_per_s']:.3f} GB/s (tinyllama), "
        f"{out['whisper']['load']['gb_per_s']:.3f} GB/s (whisper); FSM build "
        f"{out['tinyllama']['fsm_build_s']:.2f} s; peak card memory {out['peak_gb']:.2f} GB; "
        f"phase {out['phase_s']:.1f} s")
    report["hf_import"] = out


def _device_us(evt) -> float:
    """A profiler entry's own device time in us (the attribute's name
    changed across PyTorch versions)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _profile(label: str, fn, key: str, report: dict, setup=None) -> None:
    """Where one call's time goes: ``torch.profiler`` over ``fn()`` (after
    one warm call and one unprofiled timed call; ``setup()``, if given,
    runs untimed before each). Reports the device time of every kernel, the
    kernels launched, and the device's idle share: 1 - device busy time /
    the wall time of the same call timed without the profiler (which slows
    the host down). Returns nothing; fills ``report[key]`` and
    ``profile_<key>.txt`` in ``OUT_DIR``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def prepare():
        if setup is not None:
            setup()
        torch.cuda.synchronize()

    prepare()
    fn()
    prepare()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    prepare()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    busy_us = sum(_device_us(e) for e in kernels)
    n_launch = sum(e.count for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:20]
    lines = [f"{_device_us(e):12.1f} us {e.count:7d}x  {e.key[:110]}" for e in top]
    log(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms (unprofiled), device busy "
        f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}; {n_launch} kernels; "
        f"{res}")
    for ln in lines:
        log(f"[profile] {ln}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{key}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=60))
    report[f"profile_{key}"] = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
                                "idle_share": 1 - busy_us / wall_us,
                                "kernels_launched": n_launch, "result": str(res),
                                "top": lines}


def phase_profile(params, report: dict) -> None:
    """One bench parse (generate(64) on bench.py's engine shape) at ff=8 and
    one at ff=0 (every step a T = 1 forward through K2) under the
    profiler."""
    from tpu_voice_agent_torch.serve.engine import DecodeEngine
    from tpu_voice_agent_torch.services.brain import install_prompt_prefix

    for ff in (8, 0):
        eng = DecodeEngine(preset="tinyllama-1.1b", quant="int8", fast_forward=ff, max_len=1024,
                           prefill_buckets=(1024,), init_weights=False)
        eng.load_params(params)
        install_prompt_prefix(eng)
        prompt = _bench_prompt(eng, UTTERANCES[1])

        def parse(eng=eng, prompt=prompt):
            res = eng.generate(prompt, max_new_tokens=64)
            return f"{res.steps} tokens, {res.forwards} forwards + prefill"

        _profile(f"ff={ff} generate(64)", parse, f"ff{ff}", report)
        del eng


def phase_profile_stt(stt_engine, report: dict) -> None:
    """One whisper-large-v3 transcribe at the 1000-frame bucket under the
    profiler."""
    from tpu_voice_agent_torch.voicebench import synth_utterance

    audio = synth_utterance(9.8)

    def transcribe():
        r = stt_engine.transcribe(audio)
        return (f"{len(r.token_ids)} tokens, {r.forwards} forwards, encode "
                f"{r.encode_ms:.2f} ms, decode {r.decode_ms:.2f} ms")

    _profile("whisper-large-v3 transcribe (1000-frame bucket)", transcribe, "stt", report)


# ------------------------------------------------------------------ main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of card,build,digest,kernels,service,parse,batch,"
                         "batch_dense,radix,"
                         "kvquant,spec,quality,containment,tenancy,handoff,fleet,devobs,planner,"
                         "parallel,"
                         "service_batched,"
                         "golden,"
                         "batch_golden,kvquant_golden,spec_golden,stt,stt_golden,voice,"
                         "voice_service,stt_batch,hf_import,moe "
                         "(default all)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile (torch.profiler) one bench parse at ff=8 and one at "
                         "ff=0 when the service phase "
                         "runs, one ff=8 and one ff=0 batch chunk when the batch phase runs "
                         "(the same per KV tier when the kvquant phase runs), one spec parse "
                         "and one spec batch chunk when the spec phase runs, one whisper-large-v3 "
                         "transcribe when the stt phase runs, and one mixtral-8x7b parse of "
                         "each MoE dispatch when the moe phase runs")
    args = ap.parse_args()
    phases = (["card", "build", "digest", "kernels", "service", "parse", "batch", "batch_dense",
               "radix", "kvquant", "spec", "quality", "containment", "tenancy", "handoff",
               "fleet", "devobs", "planner", "parallel", "service_batched",
               "golden", "batch_golden",
               "kvquant_golden", "spec_golden", "stt", "stt_golden", "voice", "voice_service",
               "stt_batch", "hf_import", "moe"]
              if args.phases == "all" else args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import tpu_voice_agent_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing next to this script: {e}",
              file=sys.stderr)
        return 3
    from tpu_voice_agent_torch.grammar import build_intent_fsm

    t0 = time.perf_counter()
    report: dict = {}
    card = phase_card() if "card" in phases else None
    report["card"] = card
    if "build" in phases:
        report["build_s"] = phase_build(report)
    t1 = time.perf_counter()
    _tok, fsm = build_intent_fsm()
    log(f"[grammar] intent FSM: {fsm.num_states} states, {fsm.num_classes} classes, "
        f"V {fsm.vocab_size} ({time.perf_counter() - t1:.2f} s)")
    rows = {}
    if "digest" in phases:
        phase_digest(report)
    if "kernels" in phases:
        t1 = time.perf_counter()
        rows = phase_kernels(fsm, prefix_len=880)
        log(f"[kernels] phase {time.perf_counter() - t1:.1f} s")
    totals: dict = {}

    def timed(name, fn, *a, **kw):
        t1 = time.perf_counter()
        out = fn(*a, **kw)
        report.setdefault("phase_seconds", {})[name] = time.perf_counter() - t1
        log(f"[{name}] phase {time.perf_counter() - t1:.1f} s")
        return out

    if "hf_import" in phases:  # first: its brains then run before any other phase's threads
        timed("hf_import", phase_hf_import, totals, report)
    eng = timed("service", phase_service, totals, report) if "service" in phases else None
    for name, fn in (("parse", phase_parse), ("batch", phase_batch),
                     ("batch_dense", phase_batch_dense), ("radix", phase_radix),
                     ("kvquant", phase_kvquant), ("spec", phase_spec),
                     ("quality", phase_quality), ("containment", phase_containment),
                     ("tenancy", phase_tenancy), ("handoff", phase_handoff),
                     ("fleet", phase_fleet), ("devobs", phase_devobs)):
        if name in phases:
            fail_if(eng is None, f"the {name} phase reuses the service's weights")
            kw = {"profile": args.profile} if name in ("batch", "kvquant", "spec") else {}
            timed(name, fn, eng.params, totals, report, **kw)
    if "planner" in phases:  # after devobs; the planner's own bf16 weights
        timed("planner", phase_planner, totals, report)
    if "parallel" in phases:
        fail_if(eng is None, "the parallel phase reuses the service's weights")
        timed("parallel", phase_parallel, eng.params, rows, totals, report)
    if args.profile and eng is not None:  # the parse profile reuses the service's weights
        phase_profile(eng.params, report)
    del eng
    _KEPT.clear()
    if "service_batched" in phases:
        timed("service_batched", phase_service_batched, totals, report)
    if "golden" in phases:
        timed("golden", phase_golden, totals, report)
    if "batch_golden" in phases:
        timed("batch_golden", phase_batch_golden, totals, report)
    if "kvquant_golden" in phases:
        timed("kvquant_golden", phase_kvquant_golden, totals, report)
    if "spec_golden" in phases:
        timed("spec_golden", phase_spec_golden, totals, report)
    stt_eng = timed("stt", phase_stt, totals, report) if "stt" in phases else None
    if args.profile and stt_eng is not None:
        phase_profile_stt(stt_eng, report)
    if "voice" in phases:
        timed("voice", phase_voice, stt_eng, totals, report)
    del stt_eng
    if "voice_service" in phases:
        _free_cuda()
        timed("voice_service", phase_voice_service, totals, report)
    if "stt_batch" in phases:
        _free_cuda()
        timed("stt_batch", phase_stt_batch, totals, report)
    if "stt_golden" in phases:
        timed("stt_golden", phase_stt_golden, totals, report)
    if "moe" in phases:  # last: its 46 GB engines need the card to themselves
        timed("moe", phase_moe, totals, report, profile=args.profile)
    for name, r in rows.items():
        r["launches"] = totals.get(name, 0)
    report["kernels"] = list(rows.values())
    report["seconds"] = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[smoke] total {report['seconds']:.1f} s")
    log(json.dumps({"kernels": list(rows.values())}))
    if card is not None:
        log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
