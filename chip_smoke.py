#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port `embedding_cpp_tpu_torch` on one GPU.

    python3 chip_smoke.py [--out-dir DIR]   # from the repo root, on a machine
                                            # with an NVIDIA H100 and nvcc

Phases, in order, each printing JSON lines:
  device    the card (nvidia-smi name and power limit); TF32 switched off
  build     every CUDA source compiled from csrc/ with nvcc (sm_90a), in parallel;
            native_build: beside it, the three host libraries of native/
            (tokenizer, quant codec, JSON renderer) compiled with the C++
            compiler, whose path and version the line names
  kernels   each kernel against its plain PyTorch version on the card at the
            main paths' shapes, with CUDA-event times, bounds and the PyTorch
            library call that computes the same function: K1 q4_matmul at
            MiniLM-L6's and ModernBERT's linears (with the GeGLU prologue),
            the projection-layout attention K2/K3 at both models' heads
            (12 of 32, 12 of 64; K2's bound over the pairs that share a
            segment id, and the share of key tiles and 8-key runs its skip
            rule leaves out, read from seg on the host) and K4 (position
            bias), with edge inputs (shuffled ids, rows all padding, a bias
            row of -1e9, S = 1024 at d = 128), the long-row K5 and
            the sliding-window K7 (ModernBERT), K1 at DeBERTa-v3-base's linears
            and the disentangled attention K9 (key bias) / K10 (segments)
            at [32, 512, 12x64], K1 at nomic-embed-text-v1.5's linears
            (SwiGLU: silu epilogue, gate prologue), the segment attention K6
            at [8, 2048, 12x64] in both forms (windowed over chunk-sized
            segments, every key over document-sized ones) and its edge cases;
            K1 at bge-large-en-v1.5's q/k/v/o (Q8_0), at ELECTRA-small's
            linears (K2/K3 at its 4 heads of 64 too), at gtr-t5-base's
            bias-free linears and t5-v1.1-base's gated ones (gelu_tanh,
            the prologue at 2048 -> 768); K4 with a per-head [12, S, S]
            bias timed at [32, 512] as MPNet's and T5's; K1's bf16 lines name the
            tile instance its rule (`k1_tile`) picked, and each instance is
            also forced at a model shape and at a ragged M and N, every
            qtype, with the prologue and out_f32, and DeBERTa's M = 512
            relative-table projection is timed; the N-tiled K8 at its
            FFN (every qtype, bf16 and f32, beside the same call forced
            through K1) and forced at its q/k/v/o beside K1, K1's residual +
            LayerNorm epilogue at N = 384, 768,
            1024, and K2/K3 at 16 heads of 64; B1, the kernel suite's
            head-packed attention (benchmark code, on no model path), at
            [32, 512, 12x32] hb 4 and [32, 512, 12x64] hb 2 beside K5, K3
            and SDPA at the same shape, and with -1e9 padding tails; mode 3
            of the long-row kernel (segments and the sliding window) at
            ModernBERT's chunk rows [8, 2048, 12x64], at S = 1032 (no
            slice), [2, 8192] with four documents a row and with segments
            shorter and longer than the window beside a row all padding
  main      Engine.embed_tokens at MiniLM-L6 full width (384 wide, 6 layers,
            12 heads; Q4_0 weights from a seed, bf16 activations) over the
            2758-sentence STSB-profile corpus, packed and plain, f32 and int8
            output, with the kernels' launch counts, the check against the
            port's own f32 CPU path, sentences/s and in-device forward ms;
            the engine's tokenizer must be the native one
  formats   the model-format path at MiniLM-L6's width: an HF directory
            written by hand (config.json, the test vocabulary's
            tokenizer.json, pytorch_model.bin of the main phase's seed-0
            weights) converted to f32 and quantized to Q4_0 (the same kvs and
            tensors as the one-step Q4_0 conversion); Engine.from_gguf of that
            file: the main phase's parameters byte for byte and its corpus
            embeddings, packed and plain, through the same K1/K2/K3 launches;
            float16 / bfloat16 output (fetch bytes, sentences/s),
            weight_mode="dequant" (no K1), q4_impl / attn_impl "plain" (no
            launch of the matching kernels; the full forwards timed at
            [32, 512]), custom seq / batch buckets (only their shapes
            launched); the legacy .bin at f16 against the f16 GGUF; the
            server started from the Q4_0 file in its own process, with the
            f16 file as a second model (-m NAME=PATH) and --http-port:
            seconds to its first reply, TPE2 and HTTP replies against the
            int8-output Engine, the second model's route, /v1/models
  native    the STSB-profile corpus through the native tokenizer and the
            pure-Python engine at a 30522-entry vocabulary (the same ids;
            seconds each), the Q4_0 file's tensors to f16 through the
            native codec and numpy (seconds; the same bytes but for the
            sign of zero), [1024, 384] embeddings rendered to JSON natively
            and in Python (ms; parsed back bit-equal); each library in use
            is this run's build
  modernbert_main  the same corpus through ModernBERT-base at full width and
            depth (768 wide, 22 layers, 12 heads of 64, GeGLU 1152, window
            128), packed and plain: launch counts, sentences/s, in-device
            forward ms at [32, 512]
  modernbert_long  8 documents of 8192 tokens: one [8, 8192] forward through
            K5 (global layers) and K7 (local layers): documents/s, in-device
            forward ms
  modernbert_vs_cpu  min cosine against the port's f32 CPU path: 256
            sentences and a document of 2048 tokens
  modernbert_chunks  the 512 RAG chunks through Engine(pack_seq=2048): rows of
            2048 with 8 global layers on the windowed K6 and 14 local layers
            on mode 3 (154 K1 per forward, 22 with the prologue); chunks/s,
            the in-device [8, 2048] forward and its profiler breakdown, 32
            documents packed "always" (K6 over every key), min cosine
            against the f32 CPU path on 16 chunks and 2 documents
  modernbert_rerank  gte-reranker-modernbert-base's geometry (mean pooling,
            the PredictionHead): 256 MS MARCO-profile pairs through
            score_token_pairs (K3/K4), pairs/s, 64 pairs' logits against the
            CPU path, 4 pairs of 2048-4096 tokens on K5/K7 (f32 Pearson),
            each attention kernel timed at the path's shapes, the rerank
            frame
  deberta_main  DeBERTa-v3-base at full width and depth (768 wide, 12 layers,
            12 heads of 64, FFN 3072, 256 buckets out to 512) with
            mxbai-rerank-base-v1's one-logit gelu head: Engine.embed_tokens
            over the corpus, packed (K10) and plain (K9), and
            Engine.score_token_pairs over 256 query/passage pairs (K9):
            launch counts, sentences/s, pairs/s, in-device forward ms at
            [32, 512], cosine and logits (the card's bf16 and f32 paths)
            against the port's CPU path; then K9 untimed at every [B, S]
            those plain and score forwards gave it, and K10 at a short S
  nomic_main  nomic-embed-text-v1.5 at full width and depth (768 wide, 12
            layers, 12 heads of 64, SwiGLU 3072, RoPE base 1000) over the
            corpus at the default pack_seq 512, packed (K2) and plain (K3):
            84 K1 (12 with the prologue) + 12 attention launches per forward,
            sentences/s, in-device forward ms at [32, 512]
  nomic_chunks  512 RAG chunks of 128-512 tokens through Engine(pack_seq=2048):
            rows of 2048 on the windowed K6; chunks/s, padded token slots,
            the [8, 2048] forward in-device and under torch.profiler, the
            call's idle share
  nomic_documents  32 documents of 600-1400 tokens packed "always" at 2048
            (K6 over every key) and 8 documents of 8192 tokens, plain (K5,
            NTK-scaled RoPE base): documents/s, in-device forward at [8, 8192]
  nomic_vs_cpu  min cosine against the port's f32 CPU path: 256 sentences,
            16 chunks packed at 2048, a document of 2048 tokens
  nomic_unaligned  the chunks at pack_seq=2044 (S % 8 != 0): K6 padded to 2048
            inside the call, launches asserted, min cosine against the CPU
  bge_main  bge-large-en-v1.5 at full width and depth (1024 wide, 24
            layers, 16 heads of 64, FFN 4096, CLS pooling; Q8_0 weights) over
            the corpus, packed (K2) and plain (K3): 96 K1 + 48 K8 + 24
            attention launches per forward, as the route gives every planned
            batch, sentences/s, in-device forward ms at [32, 512]
  bge_vs_cpu  min cosine of the card's bf16 path and of its f32 path (K8's
            f32 form on every FFN linear) against the port's f32 CPU path,
            256 sentences
  xlmr      XLM-R base (multilingual-e5-base: 768 wide, 12 layers, 12 heads
            of 64, FFN 3072, positions from 2, one token-type row) over the
            corpus, packed (K2) and plain (K3): 72 K1 + 12 attention
            launches per forward as the route gives every planned batch,
            sentences/s, in-device forward ms at [32, 512], min cosine vs
            the f32 CPU path; then 64 untimed <s> q </s></s> p </s> pairs
            through a one-logit tanh head (bge-reranker-base's shape), held
            to the DeBERTa phase's logit bars (the bf16 Pearson bars at the
            logits' spread, BARS_LOGIT_STD)
  distilbert  multi-qa-distilbert-cos-v1 (6 layers of 768, no token types)
            the same way: 36 K1 + 6 attention launches per forward
  electra   ms-marco-electra-base: 256 MS MARCO-profile pairs through
            score_token_pairs (K3), pairs/s, the logit bars; ELECTRA-small
            (128-wide tables projected to 256 by a dense matmul) on 64
            sentences against the f32 CPU path
  mpnet     all-mpnet-base-v2 (768 wide, 12 layers, 12 heads of 64, FFN
            3072, positions from 2, a 32-bucket relative bias [12, S, S]
            shared by every layer) as XLM-R, on K4: 72 K1 + 12 K4 per
            forward; K4 then held against its plain version, untimed, at
            every [B, S] the forwards gave it with the model's own bias;
            64 double-separator pairs through a one-logit tanh head
  t5        gtr-t5-base (RMSNorm pre-norm blocks, unscaled attention on K4
            with the shared bias, relu FFN 3072, bias-free) the same way,
            the corpus framed as ids + </s>; t5_gated: a gated-GELU T5 at
            t5-v1.1-base's width (FFN 2048, K1's prologue), 64 sentences
            untimed against the f32 CPU path
  albert    albert-base-v2 (128-wide tables projected to 768, one shared
            layer applied 12 times, gelu tanh) as XLM-R, on K2/K3; 64
            [CLS] q [SEP] p [SEP] pairs through its pooler + classifier
  splade    BERT-base with the MLM head (n_vocab 30522 kept): the corpus
            through sparse_tokens(k=256), sentences/s; the tied decoder on
            K1/K8 as `route` gives every batch, checked and timed at its
            shape beside addmm and K8 forced; the card's f32 and bf16 paths
            against the CPU's
  colbert   colbertv2.0's geometry (768 -> 128 projection, query_maxlen 32,
            markers, [MASK] augmentation, the skiplist): 64 queries x 32
            documents through maxsim_rerank, documents/s, scores against
            the CPU path
  vector_index  VectorIndex on the MiniLM engine: the corpus through add()
            (Engine.embed_tokens_device: K1/K2 launched, the vectors never
            leave the card) into a bf16 and an f32 corpus, 512 queries at
            k = 10: documents/s, queries/s; both top-10s against an f64
            numpy brute force over the fetched rows (the f32 one searched
            while the process allows TF32)
  sparse_index  SparseIndex on the SPLADE engine: ingest, 512 queries exact
            and with candidates, the device search against the host
            backend; the hybrid index and its rrf_fuse search
  maxsim_index  MaxSimIndex on the ColBERT engine: the corpus through add()
            (Engine.token_states_device), 64 queries exact and with
            candidates (documents scored/s beside maxsim_rerank's); an f32
            index's scores against Engine.maxsim
  index_scale  1M unit vectors of 384 (bf16 and f32), 100,000 sparse
            documents of 256 terms, 10,000 MaxSim documents of 256 x 128:
            one 64-query search of each timed with CUDA events beside its
            bound; the 1M f32 top-10 against a numpy brute force and the
            bf16 recall@10 against it
  index_frames  the 8 index and search frames over TCP against the direct
            index calls
  http      serve(http_port=, extra_engines=) over the Q4_0 file (and the
            f16 file as a second model): /v1/embeddings with 256 texts a
            request, float and base64, against engine.encode, requests/s
            (the median of three 2 s windows an encoding) and response
            bytes by encoding, K1/K2/K3 launches per request, the server's
            engine time a request, a few requests under torch.profiler;
            /v1/tokenize, /v1/index + /v1/search, /metrics, the second
            model's route; VectorIndex ingest documents/s with the native
            tokenizer and with the Python engine
  cli       python -m embedding_cpp_tpu_torch.cli.main on the Q4_0 file as
            its own process on the card: ids, tokens and the embedding head
            against the engine's
  kernels_mesh  the kernels at the shapes a tp shard gives them: K1 at
            MiniLM-L6's q/up (column-parallel, N / tp) and o/down
            (row-parallel, K / tp, out_f32: K = 192 and 96 for o) at tp 2
            and 4, K2/K3 at 6 and 3 heads of 32, K4 at MPNet's tp 2 shard (6
            heads of 64, its [6, S, S] bias slice), each against its plain
            version, timed
  mesh      MiniLM-L6 on meshes of slots on the one card (dp 2 x tp 2, dp 1
            x tp 4: parallel/mesh.py, repeatable devices), the corpus packed
            and plain: every slot's launches, cosine against the
            single-device engine, f32 within 2e-5 of it, sentences/s beside
            its rate in this run; MPNet at tp 2 (K4 with the sliced bias)
  distributed  the server as two processes on the card through its own
            --coordinator / --num-processes / --process-id (gloo: NCCL
            refuses two ranks on one card), 64 TPE2 frames and one
            /v1/embeddings request against the single-device engine,
            SIGTERM to the leader releases the follower
  eval      benchmarks/run_eval.py --synthetic --preset minilm-l6 on the card
            in every engine mode (f32, f16, q4_0, q4_1, q8_0), at f32 and at
            the default bf16, against one f32 run on the CPU (in its own
            process, started before the build): Spearman and nDCG@10 within
            1e-3 (accuracy 0.01) at f32, every score within SCORE_TOLERANCE
            at bf16, every retrieval gate held
  headline  benchmarks/bench.py: run_headline (int8 and f32 sentences/s,
            their cosine; the in-device [32, 512] forwards within 2% of the
            main phase's, the same weights, inputs and timer) and
            run_ab_transfer
  serving   benchmarks/serving.py: 4 clients x 2048 texts in requests of 64
            over TCP (f32 and int8 wire) and HTTP (base64), and the serving
            tax A/B; every run's replies against Engine.encode
  scaling   benchmarks/scaling.py on dp 1, 2 and 4 slots of the card
  retrieval_scripts  benchmarks/search.py (its ingest model 384 wide with 4
            heads of 96), sparse.py (and --search at 100,000 documents) and
            maxsim_bench.py at their default sizes
  head_dims  head dims outside 16/32/64/128: K2/K3 checked against
            their plain versions at 4 heads of 96 (`kernels_attention` at
            [32, 512, 4x96] and the short buckets, bf16 and f32), then a
            MiniLM-L6-shaped Q4_0 Engine 384 wide with 4 heads of 96 in bf16
            over the corpus, packed (K2) and plain (K3), against the same
            Engine with attn_impl "plain" (cosine >= 0.999), no plain route
            taken; tiny-modernbert at 2 heads of 24 packed "always" at 2048,
            whose every attention call takes the plain version (no kernel
            has d 24), counted in the wrappers' `plain_routes`, against the
            f32 CPU path
  scripts   the breakdown and A/B scripts at their production shapes (the
            1000-word vocabulary cut of the main phase; fewer samples than
            their defaults): forward_breakdown (the q4_0 MiniLM-L6 [32, 512]
            forward and its pieces, accounted_pct), modernbert_breakdown
            (ModernBERT-base's pieces and the attn_impl A/B at [32, 512] and
            [8, 1024], plain and packed), packed_bse_ab (K2 against K6a and
            SDPA at [32, 512, 12x32], the packed-forward route A/Bs),
            attn_bias_smoke (every case within 0.06 of its einsum
            reference), the kernel suite's five full-forward modes, and the
            C ABI example (examples/sample_dylib.py: the library built with
            make, the port's server over the formats phase's Q4_0 file,
            tpe_connect, dylib.cpp built with g++ and run): each script's
            launches and seconds
  plain_routes  every attention wrapper's count of calls that took the plain
            version because no kernel instance serves their head dim: 0 on
            every path but the head_dims phase's d 24 engine
  profile   torch.profiler kernel times of the packed [32, 512] forwards
            (MiniLM-L6, ModernBERT, DeBERTa, bge-large, XLM-R, MPNet, T5,
            ALBERT) and of the [8, 8192] ModernBERT forward
  server    the TCP server over the GPU engines: one raw text and one TPE2
            batch (MiniLM-L6, nomic, bge-large), one rerank frame (DeBERTa,
            and the XLM-R, MPNet, ALBERT and ModernBERT cross-encoders); the
            sparse frame \x01TPW (SPLADE) and the MaxSim frame \x01TPX
            (ColBERT) against the Engine calls;
            on MiniLM-L6 also the reference's bert.h frames (health, stats,
            meta, tokenize, eval, vocab, int8 encode) and a search frame
            before any index, whose error frame leaves the connection usable
then the card's name and power limit, the `kernels` summary line (one entry
per kernel and model or index ingest: the launches beside the times at its
shapes),
and last {"ok": true, "device": {...}}.  Launch counts are set to 0 just before each
path is driven and read just after; every kernel but K1's fused tail and
B1, which no model path runs, must have launched on its path (those two
must not have).  Any failure raises and exits non-zero
before the last line.  Nothing of JAX or of the JAX package is imported.
With --out-dir, the ptxas log and the profiler tables are written there.
"""
from __future__ import annotations

import argparse
import json
import socket
import statistics
import struct
import subprocess
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from embedding_cpp_tpu_torch.benchmarks.bench import forward_inputs, synthetic_sentences
from embedding_cpp_tpu_torch.benchmarks.profiles import packed_rows, segment_pairs, serving_segments
from embedding_cpp_tpu_torch.benchmarks.serving import free_port as _free_port
from embedding_cpp_tpu_torch.benchmarks.serving import serving as _serving
from embedding_cpp_tpu_torch.utils.profiling import (
    F32_PEAKS,
    bound_ms,
    gpu_ms,
    peaks_for,
    trace,
)

ROOT = Path(__file__).resolve().parent
M_TOKENS = 32 * 512  # the packed main-path batch: 32 rows of 512 tokens

# Tolerances of the kernel checks against the plain versions on the card.
F32_ATOL = 1e-4  # the same f32 products summed in another order
BF16_REL = 1e-2  # max|err| / max|ref|: an order difference flips one bf16 rounding
# K9/K10: f32 within 1e-5; bf16 within one rounding step of outputs below 4
# (2^-6) and 1% relative
DEBERTA_F32_ATOL = 1e-5
DEBERTA_BF16_ATOL = 1.6e-2
COSINE_VS_CPU = 0.999  # bf16 GPU main path vs the port's f32 CPU path
# cross-encoder logits against the port's f32 CPU path: the card's f32 path
# (the kernels against their plain versions end to end) Pearson >= 0.999 and
# the same top-1; the bf16 main path Pearson >= 0.99, since bf16 rounding
# over 12 layers of random weights moves a logit by ~0.005 where the logits
# spread only ~0.026 (two bf16 paths that sum in different orders are as far
# apart; the deberta_vs_cpu line reports both distances)
PEARSON_F32 = 0.999
PEARSON_BF16 = 0.99
# the bf16 main path against the CPU's bf16 path: Pearson 0.9981 and max
# |err| 0.0047 in PR 3's first runs; held at 0.995 and 3x that error
PEARSON_BF16_VS_BF16 = 0.995
LOGIT_ERR_BF16_VS_BF16 = 0.015
# The two bf16 Pearson bars above were set where the f32 logits spread
# ~0.026 (DeBERTa): 1 - Pearson grows with (noise / spread)^2.  The
# BERT-graph rerankers' random-weight logits spread less (XLM-R ~0.017), so
# their bars keep the same noise-to-spread ratio: 1 - bar scales by
# max(1, (BARS_LOGIT_STD / std)^2), looser where the logits spread less.
# Their bf16 hidden states carry the noise of the JAX package's Pallas
# path, layer for layer
# (tests/test_torch_families.py::test_bf16_noise_matches_the_pallas_path).
BARS_LOGIT_STD = 0.026
COSINE_SERVER = 0.9999  # wire replies vs engine.encode
# the HTTP phase's rates: the median of HTTP_REPEATS windows of
# HTTP_WINDOW_S seconds an encoding; HTTP_PROFILED requests each profiled
HTTP_WINDOW_S, HTTP_REPEATS, HTTP_PROFILED = 2.0, 3, 4
COSINE_INT8 = 0.999  # int8 wire codes (one step is 1/127 of a row's largest value)
# each counter's TPU kernel (file:line under embedding_cpp_tpu/ops/) for the
# kernels line
KERNEL_LINES = {"q4_matmul": "q4_matmul.py:126", "q4_matmul_prologue": "q4_matmul.py:214",
                "q4_matmul_2d": "q4_matmul.py:259", "attn_bse_packed": "attention.py:213",
                "attn_bse_keybias": "attention.py:213", "attn_bse_bias": "attention.py:213",
                "attn_bse_bias_packed": "attention.py:213", "attn_long": "attention.py:26",
                "attn_local": "attention.py:597", "attn_seg": "attention.py:418",
                "attn_seg_window": "attention.py:500", "attn_seg_local": "",
                "deberta_attn": "deberta_attention.py:76",
                "deberta_attn_packed": "deberta_attention.py:185"}
ATTENTION = ("attn_bse_packed", "attn_bse_keybias", "attn_bse_bias", "attn_bse_bias_packed",
             "attn_long", "attn_local", "deberta_attn", "deberta_attn_packed", "attn_seg",
             "attn_seg_window", "attn_seg_local")


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries `t_s`, the script's seconds so
    far (where the time limit goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def reset_counts(counters) -> None:
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def read_counts(counters) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


# --- phases ------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs only on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    key, peaks = peaks_for(name)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": False, "peaks_from": key,
          "peaks": {"bytes_per_s": peaks[0], "bf16_flop_per_s": peaks[1]}})
    print(smi, flush=True)
    return name, smi, peaks


def _save(out_dir: Path | None, name: str, text: str) -> None:
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / name).write_text(text)


def phase_build(out_dir):
    from embedding_cpp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build(force=True, ptxas_verbose=True)
    wall = time.perf_counter() - t0
    check(set(built) == set(_build.SOURCES), f"built {sorted(built)}")
    _save(out_dir, "ptxas.log",
          "\n".join(f"== {k}\n{v['log']}" for k, v in built.items()))
    emit({"phase": "build", "wall_s": wall,
          "sources": {k: {"seconds": v["seconds"], "library": _build.lib_path(k).name}
                      for k, v in built.items()}})


def _rel_err(got, ref) -> tuple[float, float]:
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def _within(dtype, err: float, rel: float) -> bool:
    import torch

    return err <= F32_ATOL if dtype == torch.float32 else rel <= BF16_REL


def _tolerance(dtype) -> str:
    import torch

    return (f"max_abs_err <= {F32_ATOL}" if dtype == torch.float32
            else f"rel_err <= {BF16_REL}")


# bge-large-en-v1.5's FFN, on K8 (its q, k, v, o run K1: K1_LAYERS in the
# kernel suite, embedding_cpp_tpu_torch/benchmarks/kernels.py, holds every
# model's K1 linears)
BGE_FFN = [("up", 1024, 4096, "gelu_erf"), ("down", 4096, 1024, None)]


def _q4_weight(qtype: str, k: int, n: int, seed: int):
    """A random [k, n] weight (scale 0.02) packed as `qtype`, on the card."""
    import torch

    from embedding_cpp_tpu_torch.gguf import GGMLType
    from embedding_cpp_tpu_torch.gguf.quant import quantize
    from embedding_cpp_tpu_torch.ops import qtensor as tqt

    w_np = np.random.default_rng(seed).normal(scale=0.02, size=(n, k)).astype(np.float32)
    raw = quantize(w_np, GGMLType[qtype])
    w = (tqt.pack_q8_matmul(raw, (n, k)) if qtype == "Q8_0"
         else tqt.pack_q4_matmul(raw, (n, k), GGMLType[qtype]))
    return w.map(lambda t: t.to(torch.device("cuda")))


def _k1_tile(m: int, k: int, n: int, gated: bool) -> dict:
    """The bf16 tile instance K1 runs at this shape on this card."""
    import torch

    from embedding_cpp_tpu_torch.ops.q4_matmul import k1_tile, tile

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return tile(gated, *k1_tile(m, k, n, sms))


def phase_kernels_q4(peaks, model: str, all_types: tuple, seed: int) -> dict:
    """K1 at one model's linears per layer (`K1_LAYERS`), M = 16384: every
    shape in the main path's qtype (Q4_0; bge-large Q8_0) and bf16 (timed;
    the per-layer totals weight q/k/v/o by 4), the shapes in `all_types`
    also in the other qtypes and f32, and a ragged M edge at the up
    projection (the first shape where a model has no K1 up projection).  A
    prologue shape multiplies in the gated FFN's gate.  Every call must take
    K1's route; bf16 lines name the tile instance it ran (`k1_tile`)."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.benchmarks.kernels import K1_LAYERS
    from embedding_cpp_tpu_torch.ops.q4_matmul import dequant_weight, q4_matmul, q4_matmul_plain

    main_qtype, bias, shapes = K1_LAYERS[model]
    dev = torch.device("cuda")
    weight = _q4_weight
    gen = torch.Generator(device="cpu").manual_seed(seed)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
              "t_bytes": 0.0, "t_ops": 0.0}
    main_err, prologue_case, tiles = 0.0, None, {}
    for qtype in ("Q4_0", "Q4_1", "Q8_0"):
        for dtype in (torch.bfloat16, torch.float32):
            main = qtype == main_qtype and dtype == torch.bfloat16  # the main path's
            for name, k, n, act, per_layer, gated in shapes:
                if not main and name not in all_types:
                    continue
                w = weight(qtype, k, n, k * n + seed)
                x = torch.randn(M_TOKENS, k, generator=gen).to(dev, dtype)
                g = torch.randn(M_TOKENS, k, generator=gen).to(dev, dtype) if gated else None
                b = (torch.randn(n, generator=gen) * 0.1).to(dev) if bias else None
                before = (q4_matmul.launches, q4_matmul.prologue_launches)
                got = q4_matmul(x, w, bias=b, activation=act, prologue_mul=g)
                check((q4_matmul.launches, q4_matmul.prologue_launches)
                      == (before[0] + 1, before[1] + gated), f"{model} {name}: K1's route")
                ref = q4_matmul_plain(x, w, b, act, prologue_mul=g)
                torch.cuda.synchronize()
                err, rel = _rel_err(got, ref)
                ok = _within(dtype, err, rel)
                case = {"qtype": qtype, "dtype": str(dtype).split(".")[-1], "shape": name,
                        "m": M_TOKENS, "k": k, "n": n, "act": act, "prologue": gated,
                        **({"tile": _k1_tile(M_TOKENS, k, n, gated)}
                           if dtype == torch.bfloat16 else {}),
                        "max_abs_err": err, "rel_err": rel, "tolerance": _tolerance(dtype),
                        "ok": ok}
                if main:
                    main_err = max(main_err, err)
                    tiles[name] = "{bm}x{bn}".format(**case["tile"])
                    wd = dequant_weight(w, dtype)
                    case["ms"] = gpu_ms(lambda: q4_matmul(x, w, bias=b, activation=act,
                                                          prologue_mul=g))
                    case["plain_ms"] = gpu_ms(
                        lambda: q4_matmul_plain(x, w, b, act, prologue_mul=g),
                        samples=5, reps=1)

                    def lib():
                        xx = x * g if gated else x
                        y = torch.mm(xx, wd) if b is None else torch.addmm(b.to(dtype), xx, wd)
                        return {"gelu_erf": F.gelu, "silu": F.silu,
                                "gelu_tanh": lambda t: F.gelu(t, approximate="tanh")}[act](y) \
                            if act else y

                    case["library_ms"] = gpu_ms(lib)
                    nbytes = (x.numel() * 2 * (2 if gated else 1)
                              + w.qs.numel() * w.qs.element_size() + w.scales.numel() * 4
                              + (n * 4 if bias else 0) + M_TOKENS * n * 2)
                    flops = 2.0 * M_TOKENS * k * n
                    case["bound_ms"], case["bound_by"] = bound_ms(nbytes, flops, peaks)
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        totals[key] += per_layer * case[key]
                    totals["t_bytes"] += per_layer * nbytes / peaks[0] * 1e3
                    totals["t_ops"] += per_layer * flops / peaks[1] * 1e3
                    if gated:
                        prologue_case = case
                emit({"phase": "kernel_check", "kernel": "q4_matmul", "model": model, **case})
                check(ok, f"q4_matmul {model} {qtype} {dtype} {name}: err {err} rel {rel}")
    # ragged M edge at the up-projection shape
    name, k, n, act, _, _ = next((sh for sh in shapes if sh[0] == "up"), shapes[0])
    m = M_TOKENS - 37
    w = weight(main_qtype, k, n, 1)
    x = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
    err, rel = _rel_err(q4_matmul(x, w, activation=act), q4_matmul_plain(x, w, None, act))
    emit({"phase": "kernel_check", "kernel": "q4_matmul", "model": model, "qtype": main_qtype,
          "dtype": "bfloat16", "shape": f"{name}-ragged", "m": m, "k": k, "n": n,
          "tile": _k1_tile(m, k, n, False), "max_abs_err": err, "rel_err": rel,
          "tolerance": _tolerance(torch.bfloat16), "ok": rel <= BF16_REL})
    check(rel <= BF16_REL, f"q4_matmul {model} ragged M: rel {rel}")
    return {"max_abs_err": main_err, "per_layer": totals, "prologue": prologue_case,
            "tiles": tiles,
            "bound_by": "bytes" if totals["t_bytes"] >= totals["t_ops"] else "operations"}


def phase_kernels_k1_tiles(peaks) -> dict:
    """Each of K1's bf16 tile instances (`TC_TILES`) forced against the
    plain version in every qtype: at ModernBERT's up projection (M = 16384,
    768 -> 1152, gelu_erf) with the prologue, and at a ragged M and N
    (16347 x 1120 -> 200: K % 64 == 32, N % 16 != 0; silu) into f32
    (`out_f32`, bf16 tolerance: the inputs are bf16); each instance timed at
    the model shape in Q4_0.  Then DeBERTa's relative-table projection (M =
    512, 768 -> 768, bias, Q4_0) at the rule's instance, beside its plain
    version, addmm and the bound."""
    import torch

    from embedding_cpp_tpu_torch.benchmarks.kernels import K1_TABLE
    from embedding_cpp_tpu_torch.ops.q4_matmul import (
        TC_TILES,
        _q4_matmul_1d,
        dequant_weight,
        q4_matmul,
        q4_matmul_plain,
        route,
        tile,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(17)
    forced = {}
    for bm, bn in TC_TILES:
        for qtype in ("Q4_0", "Q4_1", "Q8_0"):
            for shape, m, k, n, act, gated, out_f32 in (
                    ("up-prologue", M_TOKENS, 768, 1152, "gelu_erf", True, False),
                    ("ragged", M_TOKENS - 37, 1120, 200, "silu", False, True)):
                w = _q4_weight(qtype, k, n, k * n + 17)
                x = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
                g = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16) if gated else None
                b = (torch.randn(n, generator=gen) * 0.1).to(dev)
                before = q4_matmul.launches

                def fn(x=x, w=w, b=b, g=g, act=act, out_f32=out_f32, t=(bm, bn)):
                    return _q4_matmul_1d(x, w, b, prologue_mul=g, activation=act,
                                         out_f32=out_f32, tile=t)
                got = fn()
                check(q4_matmul.launches == before + 1, f"K1 {bm}x{bn}: count")
                ref = q4_matmul_plain(x, w, b, act, out_f32=out_f32, prologue_mul=g)
                torch.cuda.synchronize()
                err, rel = _rel_err(got, ref)
                ok = rel <= BF16_REL and bool(torch.isfinite(got).all())
                case = {"qtype": qtype, "dtype": "bfloat16", "shape": shape, "m": m, "k": k,
                        "n": n, "act": act, "prologue": gated, "out_f32": out_f32,
                        "tile": tile(gated, bm, bn), "forced": True, "max_abs_err": err,
                        "rel_err": rel, "tolerance": _tolerance(torch.bfloat16), "ok": ok}
                if qtype == "Q4_0" and shape == "up-prologue":
                    case["ms"] = gpu_ms(fn)
                    forced[f"{bm}x{bn}"] = {k_: case[k_] for k_ in ("ms", "max_abs_err")}
                emit({"phase": "kernel_check", "kernel": "q4_matmul", "model": "modernbert-base",
                      **case})
                check(ok, f"K1 forced {bm}x{bn} {qtype} {shape}: rel {rel}")
                del x, w, b, g, got, ref
        torch.cuda.empty_cache()
    # DeBERTa's relative-table projection, as its forward runs it
    m, k, n = K1_TABLE
    w = _q4_weight("Q4_0", k, n, 19)
    x = torch.randn(m, k, generator=gen).to(dev, torch.bfloat16)
    b = (torch.randn(n, generator=gen) * 0.1).to(dev)
    check(route(m, k, n, w.qtype, x.dtype).kernel == "1d", "the table projection takes K1")
    err, rel = _rel_err(q4_matmul(x, w, bias=b), q4_matmul_plain(x, w, b))
    wd = dequant_weight(w, torch.bfloat16)
    table = {"qtype": "Q4_0", "dtype": "bfloat16", "shape": "table-projection", "m": m, "k": k,
             "n": n, "act": None, "prologue": False, "tile": _k1_tile(m, k, n, False),
             "max_abs_err": err, "rel_err": rel, "tolerance": _tolerance(torch.bfloat16),
             "ok": rel <= BF16_REL, "ms": gpu_ms(lambda: q4_matmul(x, w, bias=b)),
             "plain_ms": gpu_ms(lambda: q4_matmul_plain(x, w, b)),
             "library_ms": gpu_ms(lambda: torch.addmm(b.to(torch.bfloat16), x, wd))}
    table["bound_ms"], table["bound_by"] = bound_ms(
        x.numel() * 2 + w.qs.numel() + w.scales.numel() * 4 + n * 4 + m * n * 2,
        2.0 * m * k * n, peaks)
    emit({"phase": "kernel_check", "kernel": "q4_matmul", "model": "deberta-v3-base", **table})
    check(table["ok"], f"K1 table projection: rel {rel}")
    return {"forced": forced, "table": table}


def phase_kernels_k8(peaks, f32_rate: float) -> dict:
    """K8 against its plain version at bge-large's FFN, M = 16384 with a
    bias: up 1024 -> 4096 + gelu_erf and down 4096 -> 1024, every qtype in
    bf16 and f32, a prologue case and a ragged M.  Timed in Q8_0 bf16 (the
    main path's): K8, its plain version, torch.addmm on the dequantized
    weight (then the activation) as the library call, and the same call
    forced through K1; in f32 (the card's f32 check) at the up shape, K8,
    K1 and addmm on the f32 weight (TF32 off), with the bound at the f32
    SIMT rate.  Also K8 forced at bge-large's q/k/v/o shape (1024 -> 1024,
    which the route gives K1) beside K1 and addmm, for the record.  bf16
    cases name K8's tile (`tile`), f32 cases its column slice."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.ops.q4_matmul import (
        _q4_matmul_1d,
        _q4_matmul_2d,
        dequant_weight,
        q4_matmul,
        q4_matmul_plain,
        route,
        slice_width,
        tile,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(13)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "k1_ms": 0.0,
              "t_bytes": 0.0, "t_ops": 0.0}
    cases, main_err = {}, 0.0

    def run(qtype, dtype, name, k, n, act, m=M_TOKENS, gated=False):
        w = _q4_weight(qtype, k, n, k * n + 13)
        x = torch.randn(m, k, generator=gen).to(dev, dtype)
        g = torch.randn(m, k, generator=gen).to(dev, dtype) if gated else None
        b = (torch.randn(n, generator=gen) * 0.1).to(dev)
        before = (q4_matmul.launches, q4_matmul.n_tiled_launches)
        got = _q4_matmul_2d(x, w, b, g, activation=act)
        check((q4_matmul.launches, q4_matmul.n_tiled_launches) == (before[0], before[1] + 1),
              "K8 count")
        ref = q4_matmul_plain(x, w, b, act, prologue_mul=g)
        torch.cuda.synchronize()
        err, rel = _rel_err(got, ref)
        ok = _within(dtype, err, rel) and bool(torch.isfinite(got).all())
        del got, ref
        layout = ({"tile": tile(gated)} if dtype == torch.bfloat16
                  else {"slice_n": slice_width(k)})
        case = {"qtype": qtype, "dtype": str(dtype).split(".")[-1], "shape": name, "m": m,
                "k": k, "n": n, "act": act, "prologue": gated,
                "route": route(m, k, n, w.qtype, dtype, prologue=gated).kernel,
                **layout, "max_abs_err": err, "rel_err": rel,
                "tolerance": _tolerance(dtype), "ok": ok}
        return case, (x, w, b, g)

    for qtype in ("Q4_0", "Q4_1", "Q8_0"):
        for dtype in (torch.bfloat16, torch.float32):
            main = qtype == "Q8_0" and dtype == torch.bfloat16
            for name, k, n, act in BGE_FFN:
                case, (x, w, b, _) = run(qtype, dtype, name, k, n, act)
                if main:
                    main_err = max(main_err, case["max_abs_err"])
                    wd = dequant_weight(w, dtype)

                    def lib():
                        y = torch.addmm(b.to(dtype), x, wd)
                        return F.gelu(y) if act else y

                    case["ms"] = gpu_ms(lambda: _q4_matmul_2d(x, w, b, activation=act))
                    case["plain_ms"] = gpu_ms(lambda: q4_matmul_plain(x, w, b, act),
                                              samples=5, reps=1)
                    case["library_ms"] = gpu_ms(lib)
                    case["k1_ms"] = gpu_ms(lambda: _q4_matmul_1d(x, w, b, activation=act))
                    nbytes = (x.numel() * 2 + w.qs.numel() + w.scales.numel() * 4 + n * 4
                              + M_TOKENS * n * 2)
                    flops = 2.0 * M_TOKENS * k * n
                    case["bound_ms"], case["bound_by"] = bound_ms(nbytes, flops, peaks)
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "k1_ms"):
                        totals[key] += case[key]
                    totals["t_bytes"] += nbytes / peaks[0] * 1e3
                    totals["t_ops"] += flops / peaks[1] * 1e3
                    cases[name] = case
                    del wd
                elif qtype == "Q8_0" and name == "up":  # the f32 form
                    case["ms"] = gpu_ms(lambda: _q4_matmul_2d(x, w, b, activation=act),
                                        samples=5, reps=1)
                    case["k1_ms"] = gpu_ms(lambda: _q4_matmul_1d(x, w, b, activation=act),
                                           samples=5, reps=1)
                    case["plain_ms"] = gpu_ms(lambda: q4_matmul_plain(x, w, b, act),
                                              samples=5, reps=1)
                    wd = dequant_weight(w, dtype)
                    case["library_ms"] = gpu_ms(lambda: F.gelu(torch.addmm(b, x, wd)),
                                                samples=5, reps=1)
                    del wd
                    nbytes = (x.numel() * 4 + w.qs.numel() + w.scales.numel() * 4 + n * 4
                              + M_TOKENS * n * 4)
                    case["bound_ms"], case["bound_by"] = bound_ms(
                        nbytes, 2.0 * M_TOKENS * k * n, (peaks[0], f32_rate))
                    cases["f32_up"] = case
                emit({"phase": "kernel_check", "kernel": "q4_matmul_2d",
                      "model": "bge-large-en-v1.5", **case})
                check(case["ok"], f"K8 {qtype} {dtype} {name}: {case['max_abs_err']}")
                del x, w, b
            torch.cuda.empty_cache()
    for what, kw in (("down-prologue", {"gated": True}), ("up-ragged", {"m": M_TOKENS - 37})):
        name, k, n, act = BGE_FFN[1] if what.startswith("down") else BGE_FFN[0]
        case, _ = run("Q8_0", torch.bfloat16, what, k, n, act, **kw)
        emit({"phase": "kernel_check", "kernel": "q4_matmul_2d", "model": "bge-large-en-v1.5",
              **case})
        check(case["ok"], f"K8 {what}: {case['max_abs_err']}")
    # K8 forced at q/k/v/o, beside K1 (the route's kernel there) and addmm
    name, k, n, act = "qkvo", 1024, 1024, None
    case, (x, w, b, _) = run("Q8_0", torch.bfloat16, "qkvo-forced", k, n, act)
    wd = dequant_weight(w, torch.bfloat16)
    case["ms"] = gpu_ms(lambda: _q4_matmul_2d(x, w, b))
    case["k1_ms"] = gpu_ms(lambda: _q4_matmul_1d(x, w, b))
    case["library_ms"] = gpu_ms(lambda: torch.addmm(b.to(torch.bfloat16), x, wd))
    case["bound_ms"], case["bound_by"] = bound_ms(
        x.numel() * 2 + w.qs.numel() + w.scales.numel() * 4 + n * 4 + M_TOKENS * n * 2,
        2.0 * M_TOKENS * k * n, peaks)
    cases["qkvo_forced"] = case
    emit({"phase": "kernel_check", "kernel": "q4_matmul_2d", "model": "bge-large-en-v1.5",
          **case})
    check(case["ok"], f"K8 qkvo-forced: {case['max_abs_err']}")
    del x, w, b, wd
    torch.cuda.empty_cache()
    return {**cases, "per_layer": totals, "max_abs_err": main_err,
            "bound_by": "bytes" if totals["t_bytes"] >= totals["t_ops"] else "operations"}


def phase_kernels_ln(peaks) -> dict:
    """K1's residual + LayerNorm epilogue (bias, gelu_erf, residual,
    LayerNorm over whole rows) through q4_matmul's fused route against the
    plain version at M = 16384, N = K = 384, 768 and 1024 (MiniLM's, the
    base models' and bge-large's o projection), Q8_0, bf16 and f32, and at
    a ragged M.  Timed at N = 1024 bf16, beside K1 without the tail and the
    port's `linear` (K1, then the residual and the LayerNorm in PyTorch,
    the path the models run).  No one PyTorch call computes this function:
    library_ms is null."""
    import torch

    from embedding_cpp_tpu_torch.ops.linear import linear
    from embedding_cpp_tpu_torch.ops.q4_matmul import (
        _q4_matmul_1d,
        q4_matmul,
        q4_matmul_plain,
        route,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(14)
    result, launches = {}, 0
    for n, m in ((384, M_TOKENS), (768, M_TOKENS), (1024, M_TOKENS), (1024, M_TOKENS - 37)):
        w = _q4_weight("Q8_0", n, n, n + 14)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(m, n, generator=gen).to(dev, dtype)
            res = torch.randn(m, n, generator=gen).to(dev, dtype)
            b = (torch.randn(n, generator=gen) * 0.1).to(dev)
            ln = (1 + 0.1 * torch.randn(n, generator=gen).to(dev),
                  0.1 * torch.randn(n, generator=gen).to(dev), 1e-12)
            if m == M_TOKENS:  # q4_matmul fuses the tail here (ragged M takes K1 + PyTorch)
                check(route(m, n, n, w.qtype, dtype, residual=True, ln=True).kernel == "1d",
                      f"LN epilogue route at N={n}")
            before = q4_matmul.ln_launches
            got = _q4_matmul_1d(x, w, b, res, ln, activation="gelu_erf")
            check(q4_matmul.ln_launches == before + 1, f"LN epilogue count at N={n}")
            launches += 1
            ref = q4_matmul_plain(x, w, b, "gelu_erf", residual=res, ln=ln)
            torch.cuda.synchronize()
            err, rel = _rel_err(got, ref)
            ok = _within(dtype, err, rel) and bool(torch.isfinite(got).all())
            case = {"qtype": "Q8_0", "dtype": str(dtype).split(".")[-1], "m": m, "k": n,
                    "n": n, "act": "gelu_erf", "max_abs_err": err, "rel_err": rel,
                    "tolerance": _tolerance(dtype), "ok": ok}
            if n == 1024 and m == M_TOKENS and dtype == torch.bfloat16:
                case["ms"] = gpu_ms(lambda: _q4_matmul_1d(x, w, b, res, ln, activation="gelu_erf"))
                case["plain_ms"] = gpu_ms(
                    lambda: q4_matmul_plain(x, w, b, "gelu_erf", residual=res, ln=ln),
                    samples=5, reps=1)
                case["library_ms"] = None
                case["k1_ms"] = gpu_ms(lambda: q4_matmul(x, w, b, "gelu_erf"))
                case["linear_ms"] = gpu_ms(
                    lambda: linear(x, w, b, activation="gelu_erf", residual=res, ln=ln))
                nbytes = (3 * x.numel() * 2 + w.qs.numel() + w.scales.numel() * 4
                          + 3 * n * 4)
                case["bound_ms"], case["bound_by"] = bound_ms(nbytes, 2.0 * m * n * n, peaks)
                result = case
            emit({"phase": "kernel_check", "kernel": "q4_matmul_ln", **case})
            check(ok, f"LN epilogue N={n} M={m} {dtype}: err {err} rel {rel}")
            del x, res, got, ref
    torch.cuda.empty_cache()
    return {**result, "check_launches": launches}


def _attention_case(kernel: str, fn, plain, lib, args, nbytes: float, flops: float,
                    peaks, timed: bool, within=_within, tolerance=_tolerance,
                    **shape) -> dict:
    """One kernel check: the kernel against its plain version on the same
    inputs; with `timed`, the kernel's, the plain version's and the library
    call's ms beside the bound."""
    import torch

    got = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    err, rel = _rel_err(got, ref)
    dtype = got.dtype
    ok = within(dtype, err, rel) and bool(torch.isfinite(got).all())
    case = {**shape, "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "rel_err": rel,
            "tolerance": tolerance(dtype), "ok": ok}
    del got, ref
    if timed:
        case["ms"] = gpu_ms(lambda: fn(*args))
        case["plain_ms"] = gpu_ms(lambda: plain(*args), samples=3, reps=1)
        case["library_ms"] = gpu_ms(lib)
        case["bound_ms"], case["bound_by"] = bound_ms(nbytes, flops, peaks)
    emit({"phase": "kernel_check", "kernel": kernel, **case})
    check(ok, f"{kernel} {shape} {dtype}: err {err} rel {rel}")
    return case


def _bse_heads(t, h: int):
    """[B, S, H*d] -> contiguous [B, H, S, d] (SDPA's layout)."""
    b, s, e = t.shape
    return t.view(b, s, h, e // h).transpose(1, 2).contiguous()


def phase_kernels_attention(peaks, model: str, h: int, d: int, seed: int) -> dict:
    """K2/K3 (no position bias) at one model's heads: packed [32, 512]
    segments; key bias at [32, 512], [512, 16] and [256, 32].  MiniLM-L6
    runs them at 12 heads of 32, ModernBERT's global layers at 12 of 64.
    K2's bound counts the (query, key) pairs that share a segment id
    (`segment_pairs`), the work no skip can remove; the every-pair figure
    stays beside it on the kernel_check line (`bound_ms_all_pairs`).  The
    `bse_skips` line gives the share of key tiles and of 8-key runs that
    the kernel's skip rule leaves out at the packed shape, read on the host
    from `seg` by `bse_skips` (the kernel counts nothing).  Untimed edge
    cases: shuffled segment ids, a row all padding, a row every key of
    which is padded."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.ops.attention import (
        MASK_BIAS,
        attention_bse_plain,
        bse_skips,
        flash_attention_bse,
        flash_attention_packed_bse,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    rng = np.random.default_rng(seed)
    results = {}

    def run(kernel, b, s, mask, dtype, seg_mask, timed, flops=None):
        q, k, v = (torch.randn(b, s, h * d, generator=gen).to(dev, dtype) for _ in range(3))
        fn = flash_attention_packed_bse if seg_mask else flash_attention_bse
        heads = [_bse_heads(t, h) for t in (q, k, v)]
        lmask = ((mask[:, :, None] == mask[:, None, :])[:, None] if seg_mask
                 else mask.to(dtype)[:, None, None, :])
        nbytes = 4 * q.numel() * q.element_size() + mask.numel() * 4
        all_pairs = 4.0 * b * h * s * s * d
        extra = ({} if flops is None or not timed
                 else {"bound_ms_all_pairs": bound_ms(nbytes, all_pairs, peaks)[0]})
        return _attention_case(
            kernel, lambda *a: fn(*a, h), lambda *a: attention_bse_plain(*a, h, seg_mask),
            lambda: F.scaled_dot_product_attention(*heads, attn_mask=lmask), (q, k, v, mask),
            nbytes, all_pairs if flops is None else flops, peaks, timed, model=model, b=b, s=s,
            h=h, d=d, **extra)

    seg_np = serving_segments(rng, 32, 512)[0]
    seg = torch.from_numpy(seg_np).to(dev)
    pairs = segment_pairs(seg_np)
    kept, scored = bse_skips(torch.from_numpy(seg_np))
    emit({"phase": "bse_skips", "model": model, "shape": [32, 512],
          "computed_on": "host, from seg by ops.attention.bse_skips (the kernel's rule)",
          "tiles_skipped_share": 1.0 - kept.float().mean().item(),
          "runs_skipped_share": 1.0 - scored.float().mean().item(),
          "pair_share": pairs / (32 * 512 * 512)})
    for dtype in (torch.bfloat16, torch.float32):
        c = run("attn_bse_packed", 32, 512, seg, dtype, True, dtype == torch.bfloat16,
                flops=4.0 * h * d * pairs)
        if dtype == torch.bfloat16:
            results["attn_bse_packed"] = c
    for b, s in ((32, 512), (512, 16), (256, 32)):
        lens = rng.integers(1, s + 1, size=b)
        mask = torch.where(torch.arange(s)[None, :] < torch.from_numpy(lens)[:, None],
                           0.0, MASK_BIAS).to(torch.float32).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16 and s == 512
            c = run("attn_bse_keybias", b, s, mask, dtype, False, timed)
            if timed:
                results["attn_bse_keybias"] = c
    # edge inputs: non-contiguous ids with padding among them and a row all
    # padding; a row every key of which is padded
    shuffled = torch.from_numpy(rng.integers(-1, 6, size=(4, 512)).astype(np.int32))
    shuffled[-1] = -1
    keyb = torch.zeros(4, 512)
    keyb[1, 300:] = MASK_BIAS
    keyb[3, :] = MASK_BIAS
    for dtype in (torch.bfloat16, torch.float32):
        run("attn_bse_packed", 4, 512, shuffled.to(dev), dtype, True, False)
        run("attn_bse_keybias", 4, 512, keyb.to(dev), dtype, False, False)
    return results


def phase_kernels_bias(peaks) -> dict:
    """K4 at ModernBERT's packed/plain shape [32, 512, 12x64]: the [1, S, S]
    window bias of the local layers, and a per-head [12, S, S] bias (MPNet's
    and T5's form, keyed `/ph12`), each plain (key bias) and packed
    (segments).  Untimed
    edge cases at [4, 512, 12x64] and [2, 1024, 2x128]: a bias row of -1e9
    at every pair (where no skip is exact), shuffled segment ids with a row
    all padding, a row every key of which is padded."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.models.modernbert import window_bias
    from embedding_cpp_tpu_torch.ops.attention import (
        MASK_BIAS,
        attention_bse_plain,
        flash_attention_bias_bse,
        flash_attention_bias_packed_bse,
    )

    dev = torch.device("cuda")
    b, s, h, d = 32, 512, 12, 64
    gen = torch.Generator(device="cpu").manual_seed(3)
    rng = np.random.default_rng(3)
    seg = torch.from_numpy(serving_segments(rng, b, s)[0]).to(dev)
    lens = torch.from_numpy(rng.integers(1, s + 1, size=b))
    keyb = torch.where(torch.arange(s)[None, :] < lens[:, None], 0.0,
                       MASK_BIAS).to(torch.float32).to(dev)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(b, s, h * d, generator=gen).to(dev, dtype) for _ in range(3))
        heads = [_bse_heads(t, h) for t in (q, k, v)]
        for ph in (1, h):
            pb = (window_bias(s, 128, dev) if ph == 1
                  else torch.randn(h, s, s, generator=gen).to(dev))
            timed = dtype == torch.bfloat16
            nbytes = 4 * q.numel() * q.element_size() + b * s * 4 + pb.numel() * 4
            flops = 4.0 * b * h * s * s * d
            plain_mask = (keyb[:, None, None, :] + pb[None]).to(dtype)
            allowed = (seg[:, :, None] == seg[:, None, :])[:, None]
            packed_mask = torch.where(allowed, pb[None], MASK_BIAS).to(dtype)
            for kernel, fn, mask, lmask, seg_mask in (
                    ("attn_bse_bias", flash_attention_bias_bse, keyb, plain_mask, False),
                    ("attn_bse_bias_packed", flash_attention_bias_packed_bse, seg,
                     packed_mask, True)):
                c = _attention_case(
                    kernel, lambda *a: fn(*a, h),
                    lambda *a: attention_bse_plain(a[0], a[1], a[2], a[3], h, seg_mask, a[4]),
                    lambda: F.scaled_dot_product_attention(*heads, attn_mask=lmask),
                    (q, k, v, mask, pb), nbytes, flops, peaks, timed,
                    b=b, s=s, h=h, d=d, bias_heads=ph)
                if timed:  # ModernBERT's form, and MPNet's and T5's
                    results[kernel if ph == 1 else f"{kernel}/ph{ph}"] = c
            del plain_mask, packed_mask
    for eb, es, eh, ed in ((4, 512, 12, 64), (2, 1024, 2, 128)):
        eseg = torch.from_numpy(rng.integers(-1, 6, size=(eb, es)).astype(np.int32))
        eseg[-1] = -1
        ekeyb = torch.zeros(eb, es)
        ekeyb[0, es // 3:] = MASK_BIAS
        ekeyb[-1] = MASK_BIAS
        eseg, ekeyb = eseg.to(dev), ekeyb.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(eb, es, eh * ed, generator=gen).to(dev, dtype)
                       for _ in range(3))
            for ph in (1, eh):
                pb = torch.randn(ph, es, es, generator=gen)
                pb[:, es // 2, :] = MASK_BIAS
                pb = pb.to(dev)
                for kernel, fn, mask, seg_mask in (
                        ("attn_bse_bias", flash_attention_bias_bse, ekeyb, False),
                        ("attn_bse_bias_packed", flash_attention_bias_packed_bse, eseg, True)):
                    _attention_case(
                        kernel, lambda *a: fn(*a, eh),
                        lambda *a: attention_bse_plain(a[0], a[1], a[2], a[3], eh, seg_mask,
                                                       a[4]),
                        None, (q, k, v, mask, pb), 0.0, 0.0, peaks, False,
                        b=eb, s=es, h=eh, d=ed, bias_heads=ph, edge="bias row of -1e9")
    return results


def phase_kernels_long(peaks) -> dict:
    """K5 at [8, 8192, 12x64] bf16 with key padding, and with a [1, S, S]
    window bias at S = 2048; K7 at [8, 8192, 12x64] bf16, window 128
    (timed), and at [2, 8192, 12x64] with window 16 in bf16 and f32
    (untimed; a padded tail and a row all padding, whose blocks score the
    whole slice in both passes)."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.models.modernbert import window_bias
    from embedding_cpp_tpu_torch.ops.attention import (
        MASK_BIAS,
        attention_local_plain,
        attention_long_plain,
        flash_attention,
        flash_attention_local,
    )

    dev = torch.device("cuda")
    h, d, window = 12, 64, 128
    gen = torch.Generator(device="cpu").manual_seed(4)
    rng = np.random.default_rng(4)
    results = {}

    def inputs(b, s, dtype):
        q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dev, dtype) for _ in range(3))
        lens = torch.from_numpy(rng.integers(s // 2, s + 1, size=b))
        lens[-1] = 0  # one fully padded row
        keyb = torch.where(torch.arange(s)[None, :] < lens[:, None], 0.0,
                           MASK_BIAS).to(torch.float32).to(dev)
        return q, k, v, keyb

    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        b, s = (8, 8192) if timed else (2, 4096)
        q, k, v, keyb = inputs(b, s, dtype)
        heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        nbytes = 4 * q.numel() * q.element_size() + b * s * 4
        c = _attention_case(
            "attn_long", flash_attention, attention_long_plain,
            lambda: F.scaled_dot_product_attention(
                *heads, attn_mask=keyb[:, None, None, :].to(dtype)),
            (q, k, v, keyb), nbytes, 4.0 * b * h * s * s * d, peaks, timed,
            b=b, s=s, h=h, d=d)
        if timed:
            results["attn_long"] = c
        # the visible pairs: |q - k| <= window/2 inside the sequence
        pos = torch.arange(s)
        pairs = float((torch.clamp(pos + window // 2, max=s - 1)
                       - torch.clamp(pos - window // 2, min=0) + 1).sum())
        lmask = None
        if timed:
            posd = pos.to(dev)
            inwin = (posd[None, :] - posd[:, None]).abs() <= window // 2
            lmask = torch.where(inwin[None, None], keyb[:, None, None, :],
                                MASK_BIAS).to(dtype)
        c = _attention_case(
            "attn_local", lambda *a: flash_attention_local(*a, window),
            lambda *a: attention_local_plain(*a, window),
            (lambda: F.scaled_dot_product_attention(*heads, attn_mask=lmask)) if timed
            else None,
            (q, k, v, keyb), nbytes, 4.0 * b * h * pairs * d, peaks, timed,
            b=b, s=s, h=h, d=d, window=window)
        if timed:
            results["attn_local"] = c
        del q, k, v, heads, lmask
        torch.cuda.empty_cache()
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, keyb = inputs(2, 8192, dtype)
        _attention_case("attn_local", lambda *a: flash_attention_local(*a, 16),
                        lambda *a: attention_local_plain(*a, 16), None, (q, k, v, keyb),
                        0.0, 0.0, peaks, False, b=2, s=8192, h=h, d=d, window=16)
        del q, k, v
    # K5 with ModernBERT's [1, S, S] window bias (the path of lengths
    # without a window slice), at S = 2048
    b, s = 8, 2048
    q, k, v, keyb = inputs(b, s, torch.bfloat16)
    pb = window_bias(s, window, dev)
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    lmask = (keyb[:, None, None, :] + pb[None]).to(torch.bfloat16)
    results["attn_long_bias"] = _attention_case(
        "attn_long", flash_attention, attention_long_plain,
        lambda: F.scaled_dot_product_attention(*heads, attn_mask=lmask),
        (q, k, v, keyb, pb), 4 * q.numel() * 2 + b * s * 4 + pb.numel() * 4,
        4.0 * b * h * s * s * d, peaks, True, b=b, s=s, h=h, d=d, bias_heads=1)
    return results


def _deberta_within(dtype, err: float, rel: float) -> bool:
    import torch

    if dtype == torch.float32:
        return err <= DEBERTA_F32_ATOL
    return err <= DEBERTA_BF16_ATOL and rel <= BF16_REL


def _deberta_tolerance(dtype) -> str:
    import torch

    return (f"max_abs_err <= {DEBERTA_F32_ATOL}" if dtype == torch.float32 else
            f"max_abs_err <= {DEBERTA_BF16_ATOL} and rel_err <= {BF16_REL}")


def phase_kernels_deberta(peaks) -> dict:
    """K9 (key bias) and K10 (segments; 64 per row, then a padding tail) at
    deberta-v3-base's [32, 512, 12x64] with its 256 buckets out to 512, in
    bf16 (timed) and f32.  The library call is SDPA given the materialised
    [B, H, S, S] c2p + p2c bias (already scaled, with the key bias or the
    segment mask folded in); building that bias is not timed."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.ops.deberta_attention import (
        MASK_BIAS,
        _device_tables,
        disentangled_attention,
        disentangled_attention_packed,
        disentangled_attention_plain,
        disentangled_scores_plain,
    )
    from embedding_cpp_tpu_torch.ops.deberta_attention import work as deberta_work

    dev = torch.device("cuda")
    b, s, h, d, span, max_dist = 32, 512, 12, 64, 256, 512
    scale = 1.0 / np.sqrt(3 * d)
    gen = torch.Generator(device="cpu").manual_seed(7)
    rng = np.random.default_rng(7)
    c2p, p2c = _device_tables(s, span, max_dist, dev)
    seg_np = np.full((b, s), -1, np.int32)
    for row in range(b):
        ends = np.cumsum(rng.integers(3, 12, 64))
        seg_np[row, :ends[-1]] = np.repeat(np.arange(64), np.diff(ends, prepend=0))
    seg = torch.from_numpy(seg_np).to(dev)
    lens = torch.from_numpy(rng.integers(1, s + 1, size=b))
    keyb = torch.where(torch.arange(s)[None, :] < lens[:, None], 0.0,
                       MASK_BIAS).to(torch.float32).to(dev)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        # half-scale normal inputs keep the outputs below 4, where one bf16
        # rounding step is 2^-6
        q, k, v = (0.5 * torch.randn(b, s, h, d, generator=gen).to(dev, dtype)
                   for _ in range(3))
        pk, pq = (0.5 * torch.randn(2 * span, h, d, generator=gen).to(dev, dtype)
                  for _ in range(2))
        timed = dtype == torch.bfloat16
        flops, nbytes = deberta_work(b, s, h, d, span, q.element_size())
        heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        rel = None
        if timed:  # scaled c2p + p2c [B, H, S, S]: all three terms less q.k
            rel = (disentangled_scores_plain(q, k, pk, pq, c2p.long(), p2c.long())
                   - torch.matmul(heads[0].float(), heads[1].float().transpose(-1, -2))) * scale
        for kernel, fn, mask, seg_mask in (
                ("deberta_attn", disentangled_attention, keyb, False),
                ("deberta_attn_packed", disentangled_attention_packed, seg, True)):
            lmask = None
            if timed:
                lmask = (torch.where((seg[:, :, None] == seg[:, None, :])[:, None], rel, MASK_BIAS)
                         if seg_mask else rel + keyb[:, None, None, :]).to(dtype)
            c = _attention_case(
                kernel, lambda *a, fn=fn: fn(*a, span, max_dist),
                lambda *a, sm=seg_mask: disentangled_attention_plain(*a, c2p, p2c, sm),
                (lambda m=lmask: F.scaled_dot_product_attention(*heads, attn_mask=m, scale=scale))
                if timed else None,
                (q, k, v, mask, pk, pq), nbytes, flops, peaks, timed,
                within=_deberta_within, tolerance=_deberta_tolerance,
                b=b, s=s, h=h, d=d, span=span, max_dist=max_dist)
            if timed:
                results[kernel] = c
            del lmask
        del q, k, v, pk, pq, heads, rel
        torch.cuda.empty_cache()
    return results


def phase_kernels_deberta_shapes(shapes, span: int, max_dist: int) -> None:
    """K9 (untimed, bf16 and f32) at every [B, S] the DeBERTa main path gave
    it, deberta-v3-base's 12 heads of 64, and K10 at [64, 32] with a
    padding tail on every row and one row all padding.  At S <= 256 the
    span exceeds S and a query tile's 64-key chunk is only partly filled:
    code that the [32, 512] case never runs."""
    import torch

    from embedding_cpp_tpu_torch.ops.deberta_attention import (
        MASK_BIAS,
        _device_tables,
        disentangled_attention,
        disentangled_attention_packed,
        disentangled_attention_plain,
    )

    dev = torch.device("cuda")
    h, d = 12, 64
    gen = torch.Generator(device="cpu").manual_seed(11)
    rng = np.random.default_rng(11)
    for packed, b, s in [(False, b, s) for b, s in shapes] + [(True, 64, 32)]:
        c2p, p2c = _device_tables(s, span, max_dist, dev)
        if packed:
            seg = np.full((b, s), -1, np.int32)
            for row in range(b - 1):  # a tail of 1-4 padding slots
                ends = np.cumsum(rng.integers(1, 9, s))
                ends = ends[ends <= s - 1 - row % 4]
                seg[row, :ends[-1]] = np.repeat(np.arange(len(ends)),
                                                np.diff(ends, prepend=0))
            mask = torch.from_numpy(seg).to(dev)
        else:
            lens = torch.from_numpy(rng.integers(1, s + 1, size=b))
            mask = torch.where(torch.arange(s)[None, :] < lens[:, None], 0.0,
                               MASK_BIAS).to(torch.float32).to(dev)
        fn = disentangled_attention_packed if packed else disentangled_attention
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (0.5 * torch.randn(b, s, h, d, generator=gen).to(dev, dtype)
                       for _ in range(3))
            pk, pq = (0.5 * torch.randn(2 * span, h, d, generator=gen).to(dev, dtype)
                      for _ in range(2))
            _attention_case(
                "deberta_attn_packed" if packed else "deberta_attn",
                lambda *a, fn=fn: fn(*a, span, max_dist),
                lambda *a, sm=packed: disentangled_attention_plain(*a, c2p, p2c, sm),
                None, (q, k, v, mask, pk, pq), 0.0, 0.0, None, False,
                within=_deberta_within, tolerance=_deberta_tolerance,
                b=b, s=s, h=h, d=d, span=span, max_dist=max_dist)
            del q, k, v, pk, pq
    torch.cuda.empty_cache()


def phase_kernels_segment(peaks) -> dict:
    """K6 at nomic's packed main-path shape [8, 2048, 12x64] in bf16
    (timed) and f32: the windowed form over chunk-sized segments (128-512
    tokens, bound 512: tq 256, wmax 1408) and the full form over
    document-sized ones (600-1400 tokens, bound 2048: every key).  Untimed
    edge cases: S = 1024 with a short bound (windowed at the envelope's
    edge), S = 1152 (tq 128), S = 8192 in both forms, segments ending on
    the 256-row tiles; every row ends in padding and one is all padding;
    both forms at [3, 2048] on shuffled non-contiguous ids (ids -1..5 in no
    order, so every id span covers every id), one row all padding.
    The library call is SDPA with the boolean block-diagonal [B, 1, S, S]
    mask.  Bound: 4*H*d operations for each (query, key) pair that shares a
    segment id within the query tile's key slice, padding pairs included
    (`segment_pairs`); beside it, that of every pair of the slice,
    4*B*H*S*wmax*d (wmax = S for the full form), which is the work the
    kernel does."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.ops.attention import (
        attention_packed_plain,
        attention_packed_window_plain,
        flash_attention_packed,
        packed_window_tiles,
    )

    dev = torch.device("cuda")
    h, d = 12, 64
    gen = torch.Generator(device="cpu").manual_seed(12)
    rng = np.random.default_rng(12)
    results = {}

    def run(kernel, b, s, lo, hi, bound, dtype, timed, tile=0, empty_row=False,
            shuffled=False):
        if shuffled:  # ids -1..5 in no order: segments that are not contiguous
            seg_np = rng.integers(-1, 6, size=(b, s)).astype(np.int32)
        else:
            seg_np = packed_rows(rng, b, s, lo, hi, tile)[0]
        if empty_row:
            seg_np[-1] = -1
        tq, wmax = packed_window_tiles(s, bound)
        check((wmax is not None) == (kernel == "attn_seg_window"), f"{kernel} S={s} {bound}")
        seg = torch.from_numpy(seg_np).to(dev)
        q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dev, dtype) for _ in range(3))
        plain = ((lambda *a: attention_packed_window_plain(*a, bound)) if wmax
                 else attention_packed_plain)
        heads = allowed = None
        if timed:
            heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
            allowed = (seg[:, :, None] == seg[:, None, :])[:, None]

        def lib():
            return F.scaled_dot_product_attention(*heads, attn_mask=allowed)
        width = wmax or s
        nbytes = 4 * q.numel() * q.element_size() + seg.numel() * 4
        pairs = segment_pairs(seg_np, tq, wmax)
        c = _attention_case(
            kernel, lambda *a: flash_attention_packed(*a, bound), plain, lib, (q, k, v, seg),
            nbytes, 4.0 * h * pairs * d, peaks, timed, b=b, s=s, h=h, d=d,
            max_seg_len=bound, tq=tq, wmax=width,
            segments="shuffled ids -1..5" if shuffled else [lo, hi], tile_ends=tile or None,
            pair_share=pairs / (b * s * width))
        if timed:
            c["bound_ms_key_slice"] = bound_ms(nbytes, 4.0 * b * h * s * width * d, peaks)[0]
        return c

    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        for kernel, lo, hi, bound in (("attn_seg_window", 128, 512, 512),
                                      ("attn_seg", 600, 1400, 2048)):
            c = run(kernel, 8, 2048, lo, hi, bound, dtype, timed)
            if timed:
                results[kernel] = c
        for kernel, b, s, lo, hi, bound, tile in (
                ("attn_seg_window", 2, 1024, 16, 100, 128, 256),
                ("attn_seg_window", 2, 1152, 16, 128, 128, 128),
                ("attn_seg_window", 3, 2048, 40, 300, 512, 256),
                ("attn_seg", 3, 1152, 100, 500, None, 128),
                ("attn_seg_window", 2, 8192, 128, 512, 512, 256),
                ("attn_seg", 1, 8192, 1000, 3000, 8192, 256)):
            run(kernel, b, s, lo, hi, bound, dtype, False, tile=tile, empty_row=b > 1)
        for kernel, bound in (("attn_seg_window", 512), ("attn_seg", None)):
            run(kernel, 3, 2048, 1, 6, bound, dtype, False, empty_row=True, shuffled=True)
        torch.cuda.empty_cache()
    return results


def phase_kernels_headpack(peaks) -> dict:
    """B1, the head-packed attention of the kernel suite, against its plain
    version (divide before PV) in bf16: timed at [32, 512, 12x32] with hb 4
    and [32, 512, 12x64] with hb 2 (zero bias, as the JAX suite), beside
    K5 (`flash_attention`, [B, S, H, d]) and K3 (`flash_attention_bse`,
    [B, S, H*d]) at the same shape and SDPA (the library call, B1's own
    [B, H, S, d] layout); checked untimed at both shapes with a -1e9 padding
    tail on every row but the first and one row all padding, and at a
    ragged S.  No model path runs B1: its launches here are check launches."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.ops.attention import (
        MASK_BIAS,
        attention_headpack,
        attention_headpack_plain,
        flash_attention,
        flash_attention_bse,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(15)
    rng = np.random.default_rng(15)
    results, before = {}, attention_headpack.launches
    for b, s, h, d, hb, tail, timed in ((32, 512, 12, 32, 4, False, True),
                                        (32, 512, 12, 64, 2, False, True),
                                        (32, 512, 12, 32, 4, True, False),
                                        (32, 512, 12, 64, 2, True, False),
                                        (4, 300, 12, 64, 2, True, False)):
        q, k, v = (torch.randn(b, h, s, d, generator=gen).to(dev, torch.bfloat16)
                   for _ in range(3))
        bias = torch.zeros(b, s)
        if tail:
            lens = torch.from_numpy(rng.integers(1, s + 1, size=b))
            lens[0], lens[-1] = s, 0
            bias = torch.where(torch.arange(s)[None, :] < lens[:, None], 0.0, MASK_BIAS)
        bias = bias.to(torch.float32).to(dev)
        c = _attention_case(
            "attention_headpack", lambda *a: attention_headpack(*a, hb),
            lambda *a: attention_headpack_plain(*a, hb),
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias[:, None, None, :].to(q.dtype)),
            (q, k, v, bias), 4 * q.numel() * 2 + bias.numel() * 4, 4.0 * b * h * s * s * d,
            peaks, timed, b=b, s=s, h=h, d=d, hb=hb, padding_tail=tail)
        if timed:
            rows = [t.transpose(1, 2).contiguous() for t in (q, k, v)]  # [B, S, H, d]
            proj = [t.view(b, s, h * d) for t in rows]
            c["k5_ms"] = gpu_ms(lambda: flash_attention(*rows, bias))
            c["k3_ms"] = gpu_ms(lambda: flash_attention_bse(*proj, bias, h))
            emit({"phase": "kernel_time", "kernel": "attention_headpack", "b": b, "s": s,
                  "h": h, "d": d, "hb": hb, "k5_ms": c["k5_ms"], "k3_ms": c["k3_ms"]})
            results[f"d{d}_hb{hb}"] = c
            del rows, proj
        del q, k, v
    torch.cuda.empty_cache()
    return {**results, "check_launches": attention_headpack.launches - before}


def _packed_plan(eng, token_lists) -> list:
    """The packed batches the engine's plan launches for the lists."""
    from embedding_cpp_tpu_torch.runtime.batching import pack_segments

    plan = eng._pack_plan(token_lists)
    if not plan:
        return []
    return pack_segments([token_lists[i] for i in plan], plan, eng.special_ids.pad,
                         seq_len=eng.pack_seq, n_seg=eng.pack_segs)


def _planned_forwards(eng, token_lists) -> tuple[int, int]:
    """(packed, plain) forwards the engine's plan launches for the lists."""
    from embedding_cpp_tpu_torch.runtime.batching import pack_batches

    rest = sorted(set(range(len(token_lists))) - set(eng._pack_plan(token_lists)))
    plain = len(pack_batches([token_lists[i] for i in rest], eng.special_ids.pad,
                             seq_buckets=eng.seq_buckets, batch_buckets=eng.batch_buckets,
                             max_seq=eng.config.n_ctx, max_tokens=eng.max_batch_tokens))
    return len(_packed_plan(eng, token_lists)), plain


def _expected_forwards(eng, token_lists) -> int:
    return sum(_planned_forwards(eng, token_lists))


def phase_main(counters) -> tuple:
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import MINILM_L6, ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch, bert_embed_packed

    # the `minilm-l6` preset: MiniLM-L6's full width, synthetic 1000-word vocab
    config = replace(MINILM_L6, n_vocab=1000, name="minilm-l6-synthetic")
    base = Engine.synthetic(config, "q4_0", seed=0,
                            opts=ComputeOptions(dtype="bfloat16"), device="cuda")
    # the engine tokenizes natively: a fall-through to the Python engine
    # would hide a library that did not build
    check(type(base.tokenizer).__name__ == "NativeTokenizer",
          f"the main engine's tokenizer is {type(base.tokenizer).__name__}")
    engines = {
        (packing, od): Engine(base.params, config, base.tokenizer, base.special_ids,
                              opts=ComputeOptions(dtype="bfloat16", output_dtype=od),
                              device="cuda", packing=packing)
        for packing in ("auto", "never") for od in ("float32", "int8")
    }
    texts = synthetic_sentences(2758, seed=0)
    t0 = time.perf_counter()
    token_lists = base.tokenize_batch(texts)
    tok_s = time.perf_counter() - t0
    n_tokens = sum(len(t) for t in token_lists)

    launches, outs = {}, {}
    for (packing, od), eng in engines.items():
        reset_counts(counters)
        outs[(packing, od)] = eng.embed_tokens(token_lists)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        forwards = _expected_forwards(eng, token_lists)
        launches[(packing, od)] = counts
        attn = counts["attn_bse_packed"] + counts["attn_bse_keybias"]
        emit({"phase": "main_launches", "packing": packing, "output": od,
              "forwards": forwards, "launches": counts})
        check(counts["q4_matmul"] == 36 * forwards and counts["q4_matmul_2d"] == 0,
              f"{packing}/{od}: K1 {counts}")
        check(attn == 6 * forwards, f"{packing}/{od}: attention {counts}")
        check(sum(counts[k] for k in ATTENTION) == attn, f"{packing}/{od}: {counts}")
        used = "attn_bse_packed" if packing == "auto" else "attn_bse_keybias"
        check(counts[used] > 0 and counts["q4_matmul"] > 0, f"{packing}/{od}: {counts}")

    for key, out in outs.items():
        norms = np.linalg.norm(out, axis=-1)
        tol = 1e-3 if key[1] == "float32" else 2e-2
        check(np.isfinite(out).all(), f"{key}: non-finite output")
        check(out.shape == (len(texts), 384), f"{key}: shape {out.shape}")
        check(np.abs(norms - 1.0).max() <= tol, f"{key}: norms {norms.min()}..{norms.max()}")

    # yardstick: the same weights on the port's f32 CPU path (plain versions)
    cpu = Engine.synthetic(config, "q4_0", seed=0, device="cpu")
    ref = cpu.embed_tokens(token_lists[:256])
    cos = {f"{p}/{o}": float(np.min(np.sum(outs[(p, o)][:256] * ref, -1)
                                    / np.linalg.norm(outs[(p, o)][:256], axis=-1)))
           for p, o in outs}
    emit({"phase": "main_vs_cpu", "sentences": 256, "min_cosine": cos,
          "threshold": COSINE_VS_CPU})
    check(min(cos.values()) >= COSINE_VS_CPU, f"cosine vs CPU {cos}")

    # throughput: best of 5 interleaved runs on the pre-tokenized lists
    best = {key: float("inf") for key in engines}
    for _ in range(5):
        for key, eng in engines.items():
            t0 = time.perf_counter()
            eng.embed_tokens(token_lists)
            best[key] = min(best[key], time.perf_counter() - t0)
    sps = {f"{p}/{o}": len(texts) / t for (p, o), t in best.items()}

    # in-device forward at [32, 512], plain and packed (the headline bench's
    # inputs: benchmarks/bench.forward_inputs)
    opts = ComputeOptions(dtype="bfloat16")
    ids, mask, pids, seg, pos = forward_inputs(config.n_vocab, torch.device("cuda"))
    with torch.inference_mode():
        # a forward is ~240 launches: spin long enough to queue all of them
        plain_ms = gpu_ms(lambda: bert_embed_batch(base.params, ids, mask, config, opts),
                          samples=5, reps=4, spin=200_000_000)
        packed_ms = gpu_ms(lambda: bert_embed_packed(base.params, pids, seg, pos, config,
                                                     opts, n_seg=64),
                           samples=5, reps=4, spin=200_000_000)
    i8_cos = float(np.min(np.sum(outs[("auto", "float32")] * outs[("auto", "int8")], -1)
                          / np.linalg.norm(outs[("auto", "int8")], axis=-1)))
    result = {
        "phase": "main", "model": config.name, "weights": "q4_0",
        "activations": "bfloat16", "sentences": len(texts), "tokens": n_tokens,
        "tokenize_s": tok_s, "sentences_per_sec": sps,
        "sentences_per_sec_int8": sps["auto/int8"],
        "sentences_per_sec_f32": sps["auto/float32"],
        "int8_cosine_vs_f32_min": i8_cos,
        "forward_ms_in_device_b32_s512": plain_ms,
        "packed_forward_ms_in_device_b32_s512": packed_ms,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit(result)
    total = {name: sum(c[name] for c in launches.values()) for name in counters}
    main = {"config": config, "base": base, "engines": engines, "outs": outs,
            "launches": launches, "forward_ms": {"plain": plain_ms, "packed": packed_ms},
            "sentences_per_sec": sps,
            "forward_inputs": (ids, mask, pids, seg, pos)}
    return (engines[("auto", "float32")], (base.params, config, pids, seg, pos),
            total, token_lists, main)


def _caught(fn) -> dict:
    """{"result": fn()} or {"error": the exception} (for a thread)."""
    try:
        return {"result": fn()}
    except Exception as e:  # re-raised by the caller, on the main thread
        return {"error": f"{type(e).__name__}: {e}"}


def phase_native_build() -> dict:
    """The three host libraries (tokenizer, quant codec, JSON renderer)
    compiled from `native/` with the C++ compiler, all at once."""
    from embedding_cpp_tpu_torch.utils import native_build

    cxx = native_build.compiler()
    version = native_build.compiler_version(cxx)
    t0 = time.perf_counter()
    built = native_build.build(force=True)
    wall = time.perf_counter() - t0
    check(set(built) == set(native_build.LIBRARIES.sources), f"native built {sorted(built)}")
    return {"phase": "native_build", "compiler": cxx, "compiler_version": version,
            "wall_s": wall,
            "libraries": {k: {"seconds": v["seconds"],
                              "library": native_build.lib_path(k).name}
                          for k, v in built.items()}}


def phase_native(main: dict, q4_path: Path) -> dict:
    """The host libraries on the main path's data: (a) the STSB-profile
    corpus through the native tokenizer and the pure-Python engine at
    MiniLM's vocabulary size (30522 entries of the test vocabulary): the same
    ids, and each one's seconds; (b) the Q4_0 GGUF's tensors to f16 through
    the native codec and the numpy codecs: seconds, and the same bytes but
    for the sign of zero (+0.0 native, -0.0 numpy, from a code of 8 under a
    negative scale); (c) the HTTP float rendering of [1024, 384] embeddings,
    native and Python: ms, and the numbers parse back bit-equal.  Each
    library in use is the one this run built."""
    from embedding_cpp_tpu_torch.gguf import GGMLType, native_codec
    from embedding_cpp_tpu_torch.gguf.quant import dequantize, quantize
    from embedding_cpp_tpu_torch.gguf.reader import GGUFReader
    from embedding_cpp_tpu_torch.tokenizer import load_tokenizer
    from embedding_cpp_tpu_torch.tokenizer.native import NativeTokenizer
    from embedding_cpp_tpu_torch.tokenizer.testvocab import build_tokenizer_json
    from embedding_cpp_tpu_torch.utils import jsonfmt, native_build

    t_phase = time.perf_counter()
    # (a)
    texts = synthetic_sentences(2758, seed=0)
    blob = build_tokenizer_json(30522)
    nat, py = NativeTokenizer(blob), load_tokenizer(blob, "python")
    nat_ids = nat.encode_batch(texts)
    py_ids = py.encode_batch(texts)
    ids_equal = [a.tolist() for a in nat_ids] == py_ids
    nat_s = _best_s(lambda: nat.encode_batch(texts), 3)
    py_s = _best_s(lambda: py.encode_batch(texts), 2)
    # (b)
    with GGUFReader(q4_path) as r:
        tensors = [(np.array(r.tensor_raw(name)), info.n_elements)
                   for name, info in r.tensors.items() if info.ggml_type == GGMLType.Q4_0]
    t0 = time.perf_counter()
    nat_f16 = [native_codec.requantize(raw, GGMLType.Q4_0, n, GGMLType.F16)
               for raw, n in tensors]
    codec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    np_f16 = [quantize(dequantize(raw, GGMLType.Q4_0, n), GGMLType.F16) for raw, n in tensors]
    numpy_s = time.perf_counter() - t0
    n_values = sum(n for _, n in tensors)
    diff = other = 0
    for a, b in zip(nat_f16, np_f16):
        a, b = a.view(np.uint16), b.view(np.uint16)
        d = a != b
        diff += int(d.sum())
        other += int(np.sum(~((a[d] == 0) & (b[d] == 0x8000))))
    # (c)
    vecs = np.ascontiguousarray(main["outs"][("auto", "float32")][:1024])
    rendered = jsonfmt.embedding_data_json(vecs)
    back = np.array([d["embedding"] for d in json.loads(rendered)], np.float32)
    bit_equal = back.shape == vecs.shape and np.array_equal(back.view(np.uint32),
                                                            vecs.view(np.uint32))
    native_ms = _best_s(lambda: jsonfmt.embedding_data_json(vecs), 5) * 1e3
    python_ms = _best_s(lambda: jsonfmt._py_embedding_data(vecs), 3) * 1e3
    in_use = native_build.loaded()
    out = {"phase": "native", "sentences": len(texts), "vocab": 30522,
           "tokens": int(sum(len(t) for t in py_ids)), "ids_equal": ids_equal,
           "tokenize_s": {"native": nat_s, "python": py_s},
           "main_engine_tokenizer": type(main["base"].tokenizer).__name__,
           "codec_tensors": len(tensors), "codec_values": n_values,
           "requantize_q4_0_to_f16_s": {"native": codec_s, "numpy": numpy_s},
           "f16_values_differing": diff, "f16_differing_not_sign_of_zero": other,
           "jsonfmt_shape": list(vecs.shape), "jsonfmt_bytes": len(rendered),
           "jsonfmt_ms": {"native": native_ms, "python": python_ms},
           "jsonfmt_bit_equal": bit_equal,
           "libraries_in_use": {k: Path(v).name for k, v in in_use.items()},
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    check(ids_equal, "native tokenizer ids differ from the Python engine's")
    check(len(tensors) > 0 and other == 0, f"native codec differs from numpy beyond the sign of zero "
                                  f"({other} values)")
    check(jsonfmt.available() and bit_equal, "jsonfmt output does not parse back bit-equal")
    check(sorted(in_use) == sorted(native_build.LIBRARIES.sources)
          and all(Path(v) == native_build.lib_path(k) for k, v in in_use.items()),
          f"libraries in use {in_use}")
    return out


# --- formats: convert -> quantize -> load -> serve, from files the port wrote ---

def _hf_minilm_dir(d: Path, config) -> None:
    """A MiniLM-L6 HF checkpoint directory written by hand (the card has no
    `transformers`): a BertModel config.json, the WordPiece test
    vocabulary's tokenizer.json and a pytorch_model.bin holding
    random_state_dict(config, 0), the weights Engine.synthetic makes."""
    import torch

    from embedding_cpp_tpu_torch.models.params import random_state_dict
    from embedding_cpp_tpu_torch.tokenizer.testvocab import build_tokenizer_json

    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps({
        "architectures": ["BertModel"], "model_type": "bert", "vocab_size": config.n_vocab,
        "hidden_size": config.n_embd, "num_hidden_layers": config.n_layer,
        "num_attention_heads": config.n_head, "intermediate_size": config.n_ff,
        "max_position_embeddings": config.n_ctx, "type_vocab_size": config.n_token_types,
        "layer_norm_eps": config.layer_norm_eps, "hidden_act": "gelu"}))
    (d / "tokenizer.json").write_bytes(build_tokenizer_json(config.n_vocab))
    torch.save({k: torch.from_numpy(v) for k, v in random_state_dict(config, 0).items()},
               d / "pytorch_model.bin")


def _same_gguf(a: Path, b: Path) -> bool:
    """The same kv pairs (values and types, in any order) and the same
    tensor directory and data, byte for byte."""
    from embedding_cpp_tpu_torch.gguf.reader import GGUFReader

    with GGUFReader(a) as x, GGUFReader(b) as y:
        if sorted(x.kv) != sorted(y.kv) or list(x.tensors) != list(y.tensors):
            return False
        for k, v in x.kv.items():
            w = y.kv[k]
            if isinstance(v, np.ndarray):
                if not (isinstance(w, np.ndarray) and v.dtype == w.dtype
                        and np.array_equal(v, w)):
                    return False
            elif type(v) is not type(w) or v != w:
                return False
        return all(x.tensors[n] == y.tensors[n]
                   and np.array_equal(x.tensor_raw(n), y.tensor_raw(n)) for n in x.tensors)


def _param_leaves(params: dict, prefix: str = ""):
    from embedding_cpp_tpu_torch.ops.qtensor import QTensor

    for k, v in params.items():
        if isinstance(v, dict):
            yield from _param_leaves(v, f"{prefix}{k}.")
        elif isinstance(v, QTensor):
            for f in ("qs", "scales", "mins"):
                if getattr(v, f) is not None:
                    yield f"{prefix}{k}.{f}", getattr(v, f)
        else:
            yield prefix + k, v


def _same_params(a: dict, b: dict) -> bool:
    import torch

    x, y = dict(_param_leaves(a)), dict(_param_leaves(b))
    return sorted(x) == sorted(y) and all(
        x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and torch.equal(x[k], y[k])
        for k in x)


def _counted_embed(counters, eng, token_lists) -> tuple[np.ndarray, dict]:
    import torch

    reset_counts(counters)
    out = eng.embed_tokens(token_lists)
    torch.cuda.synchronize()
    return out, read_counts(counters)


def _max_rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def phase_formats(counters, main: dict, token_lists) -> dict:
    """The model-format path on the card, at MiniLM-L6's full width: (a)
    an HF directory written by hand, converted to f32 and quantized to
    Q4_0 (the same tensors and kvs as the one-step Q4_0 conversion); (b)
    that file through Engine.from_gguf on the card: the main phase's
    parameters byte for byte and its embeddings of the corpus, packed and
    plain, through the same K1/K2/K3 launches; (c) the Engine's switches:
    float16 / bfloat16 output, weight_mode="dequant" (no K1), q4_impl /
    attn_impl "plain" (no launch of the matching kernels; both full
    forwards timed at [32, 512]), custom buckets (only their shapes
    launched); (d) the legacy .bin at f16 against the f16 GGUF; (e) the
    server started from the Q4_0 file as a subprocess: seconds to its first
    reply, TPE2 replies against the int8-output Engine.  Returns the launch
    counts of (b)."""
    import tempfile

    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch
    from embedding_cpp_tpu_torch.models.convert import convert_hf_dir, convert_hf_dir_to_legacy
    from embedding_cpp_tpu_torch.models.quantize_tool import quantize_gguf
    from embedding_cpp_tpu_torch.runtime import engine as engine_mod

    config, base = main["config"], main["base"]
    bf16 = ComputeOptions(dtype="bfloat16")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_formats_")
    root = Path(tmp.name)
    hf, f32_path, q4_path = root / "minilm-l6-synthetic", root / "f32.gguf", root / "q4_0.gguf"

    # (a) HF directory -> f32 -> Q4_0, beside the one-step conversion
    t0 = time.perf_counter()
    _hf_minilm_dir(hf, config)
    t_dir = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert_hf_dir(hf, f32_path, "f32")
    t_convert = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = quantize_gguf(str(f32_path), str(q4_path), "q4_0", verbose=False)
    t_quantize = time.perf_counter() - t0
    convert_hf_dir(hf, root / "q4_0_direct.gguf", "q4_0")
    same_as_direct = _same_gguf(q4_path, root / "q4_0_direct.gguf")
    emit({"phase": "formats_files", "hf_dir_s": t_dir, "convert_f32_s": t_convert,
          "quantize_q4_0_s": t_quantize, "f32_bytes": f32_path.stat().st_size,
          "q4_0_bytes": q4_path.stat().st_size, "quantized": stats.n_quantized,
          "kept": stats.n_kept, "hist": stats.hist_all.tolist(),
          "same_as_one_step_q4_0": same_as_direct,
          "byte_identical_to_one_step": q4_path.read_bytes() == (
              root / "q4_0_direct.gguf").read_bytes()})
    check(same_as_direct, "quantize_gguf(f32) differs from convert_hf_dir(q4_0)")

    # (b) the Q4_0 file on the card against the main phase
    t0 = time.perf_counter()
    loaded = Engine.from_gguf(str(q4_path), opts=bf16, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    check(_same_params(loaded.params, base.params), "from_gguf params != Engine.synthetic's")
    # the file holds eps as f32, which the forward adds as f32 either way
    check(replace(loaded.config, name="", layer_norm_eps=float(np.float32(config.layer_norm_eps)))
          == replace(config, name="", layer_norm_eps=float(np.float32(config.layer_norm_eps))),
          f"config {loaded.config}")
    # the main path's own run-to-run spread: the bar for "equal"
    spread = max(float(np.abs(main["engines"][(p, "float32")].embed_tokens(token_lists)
                              - main["outs"][(p, "float32")]).max())
                 for p in ("auto", "never"))
    gguf = {"auto": loaded, "never": Engine(loaded.params, loaded.config, loaded.tokenizer,
                                            loaded.special_ids, opts=bf16, device="cuda",
                                            packing="never")}
    outs, counts, diffs = {}, {}, {}
    for packing, eng in gguf.items():
        outs[packing], counts[packing] = _counted_embed(counters, eng, token_lists)
        want = main["launches"][(packing, "float32")]
        diffs[packing] = float(np.abs(outs[packing] - main["outs"][(packing, "float32")]).max())
        emit({"phase": "formats_gguf", "packing": packing, "launches": counts[packing],
              "main_launches": want, "max_abs_diff_vs_main": diffs[packing],
              "main_run_to_run": spread})
        check(counts[packing] == want, f"gguf {packing}: launches {counts[packing]} != {want}")
        check(diffs[packing] <= spread, f"gguf {packing}: {diffs[packing]} vs main, spread "
                                        f"{spread}")
    emit({"phase": "formats_load", "load_s": t_load, "params_equal": True,
          "embeddings_equal_main": max(diffs.values()) == 0.0})

    # (c) the switches on the loaded parameters
    def variant(**kw):
        packing = kw.pop("packing", "auto")
        return Engine(loaded.params, loaded.config, loaded.tokenizer, loaded.special_ids,
                      opts=ComputeOptions(dtype="bfloat16", **kw), device="cuda",
                      packing=packing)

    ref = outs["auto"]
    out_engines = {od: variant(output_dtype=od) for od in ("float16", "bfloat16", "int8")}
    dtype_err = {}
    for od, bar in (("float16", 1e-3), ("bfloat16", 8e-3)):
        got = out_engines[od].embed_tokens(token_lists)
        dtype_err[od] = float(np.abs(got - ref).max())
        check(dtype_err[od] <= bar, f"{od} output: max |diff| {dtype_err[od]} > {bar}")
    rates = {od: float("inf") for od in ("float32", "float16", "bfloat16", "int8")}
    timed = {"float32": loaded, **out_engines}
    for _ in range(3):
        for od, eng in timed.items():
            t0 = time.perf_counter()
            eng.embed_tokens(token_lists)
            rates[od] = min(rates[od], time.perf_counter() - t0)
    n = len(token_lists)
    e = config.n_embd
    fetch_bytes = {"float32": n * e * 4, "float16": n * e * 2, "bfloat16": n * e * 2,
                   "int8": n * (e + 4)}
    emit({"phase": "formats_output_dtypes", "max_abs_diff_vs_f32": dtype_err,
          "bars": {"float16": 1e-3, "bfloat16": 8e-3}, "fetch_bytes": fetch_bytes,
          "sentences_per_sec": {od: n / t for od, t in rates.items()}})

    dequant = Engine.from_gguf(str(q4_path), weight_mode="dequant", opts=bf16, device="cuda")
    got, c = _counted_embed(counters, dequant, token_lists)
    attn = {k: v for k, v in c.items() if k in ATTENTION}
    dequant_cos = _min_cos(got, ref)
    check(c["q4_matmul"] == 0 and c["q4_matmul_2d"] == 0, f"dequant: K1 launched {c}")
    check(attn == {k: v for k, v in counts["auto"].items() if k in ATTENTION},
          f"dequant: attention {attn}")
    check(dequant_cos >= 0.999, f"dequant cosine {dequant_cos}")
    emit({"phase": "formats_dequant", "launches": c, "min_cosine_vs_q4": dequant_cos})

    plains = {}
    for tag, kw in (("q4_plain", dict(q4_impl="plain")), ("attn_plain", dict(attn_impl="plain")),
                    ("both_plain", dict(q4_impl="plain", attn_impl="plain"))):
        for packing in ("auto", "never"):
            got, c = _counted_embed(counters, variant(packing=packing, **kw), token_lists)
            k1 = c["q4_matmul"] + c["q4_matmul_2d"]
            n_attn = sum(c[k] for k in ATTENTION)
            want = counts[packing]
            if "q4_impl" in kw:
                check(k1 == 0, f"{tag}/{packing}: K1 launched {c}")
            else:
                check(k1 == want["q4_matmul"], f"{tag}/{packing}: K1 {c}")
            if "attn_impl" in kw:
                check(n_attn == 0, f"{tag}/{packing}: attention launched {c}")
            else:
                check(n_attn == sum(want[k] for k in ATTENTION), f"{tag}/{packing}: {c}")
            rel = _max_rel(got, outs[packing])
            plains[f"{tag}/{packing}"] = {"k1": k1, "attention": n_attn, "max_rel_err": rel,
                                          "min_cosine": _min_cos(got, outs[packing])}
            check(rel <= BF16_REL, f"{tag}/{packing}: max rel err {rel} > {BF16_REL}")
    ids, mask = main["forward_inputs"][:2]
    forward_ms = {}
    with torch.inference_mode():
        for tag, params, opts in (
                ("kernels", loaded.params, bf16),
                ("q4_plain", loaded.params, ComputeOptions(dtype="bfloat16", q4_impl="plain")),
                ("attn_plain", loaded.params, ComputeOptions(dtype="bfloat16",
                                                             attn_impl="plain")),
                ("both_plain", loaded.params, ComputeOptions(dtype="bfloat16", q4_impl="plain",
                                                             attn_impl="plain")),
                ("dequant", dequant.params, bf16)):
            forward_ms[tag] = gpu_ms(
                lambda: bert_embed_batch(params, ids, mask, config, opts),
                samples=5, reps=4, spin=200_000_000)
    emit({"phase": "formats_switches", "plain": plains, "bar_max_rel_err": BF16_REL,
          "forward_ms_in_device_b32_s512": forward_ms})

    buckets = Engine(loaded.params, loaded.config, loaded.tokenizer, loaded.special_ids,
                     opts=bf16, device="cuda", packing="never", seq_buckets=(32, 128),
                     batch_buckets=(64,))
    shapes = []
    real = engine_mod.bert_embed_batch

    def recorded(params, ids, *a, **kw):
        shapes.append(tuple(ids.shape))
        return real(params, ids, *a, **kw)

    # the corpus and 64 lists of 33-120 tokens (four sentences joined), so
    # both buckets are reached
    long_lists = [[t for j in range(4 * i, 4 * i + 4) for t in token_lists[j][1:-1]][:118]
                  for i in range(64)]
    long_lists = [[token_lists[0][0], *ids, token_lists[0][-1]] for ids in long_lists]
    lists = token_lists + long_lists
    engine_mod.bert_embed_batch = recorded
    try:
        got, c = _counted_embed(counters, buckets, lists)
    finally:
        engine_mod.bert_embed_batch = real
    bucket_cos = _min_cos(got, gguf["never"].embed_tokens(lists))
    check(set(shapes) == {(64, 32), (64, 128)}, f"bucket shapes {set(shapes)}")
    check(c["q4_matmul"] == 36 * len(shapes) and c["attn_bse_keybias"] == 6 * len(shapes),
          f"buckets: {c} for {len(shapes)} forwards")
    check(bucket_cos >= 0.999, f"custom buckets cosine {bucket_cos}")
    emit({"phase": "formats_buckets", "seq_buckets": [32, 128], "batch_buckets": [64],
          "lists": len(lists), "longest": max(map(len, lists)),
          "shapes": sorted(set(shapes)), "forwards": len(shapes), "launches": c,
          "min_cosine_vs_default": bucket_cos})

    # (d) the legacy .bin at f16 against the f16 GGUF
    t0 = time.perf_counter()
    convert_hf_dir_to_legacy(hf, root / "m.bin", "f16")
    t_legacy = time.perf_counter() - t0
    convert_hf_dir(hf, root / "f16.gguf", "f16")
    legacy = Engine.from_legacy_bin(str(root / "m.bin"), opts=bf16, device="cuda")
    f16 = Engine.from_gguf(str(root / "f16.gguf"), opts=bf16, device="cuda")
    check(_same_params(legacy.params, f16.params), "legacy params != f16 GGUF params")
    # what the server below answers for the f16 file, its second model
    server_texts = ["hello world", "the quick brown fox jumps over the lazy dog",
                    "welcome back soon", "store buy apple banana", "partly cloudy outside"]
    want_f16 = Engine(f16.params, f16.config, f16.tokenizer, f16.special_ids, device="cuda",
                      opts=ComputeOptions(dtype="bfloat16", output_dtype="int8")
                      ).encode(server_texts)
    a, b = legacy.embed_tokens(token_lists), f16.embed_tokens(token_lists)
    legacy_diff = float(np.abs(a - b).max())
    check(legacy_diff <= spread, f"legacy vs f16 GGUF: {legacy_diff}")
    emit({"phase": "formats_legacy", "convert_s": t_legacy,
          "bin_bytes": (root / "m.bin").stat().st_size, "max_abs_diff_vs_f16_gguf": legacy_diff,
          "f16_min_cosine_vs_q4": _min_cos(b, ref)})
    del legacy, f16, dequant, out_engines, buckets
    torch.cuda.empty_cache()

    # (e) the server from the Q4_0 file, in its own process, with the f16
    # file as a second model on its HTTP port
    texts = server_texts
    want = variant(output_dtype="int8").encode(texts)
    port, http_port = _free_port(), _free_port()
    body = b"".join(struct.pack("<I", len(t.encode())) + t.encode() for t in texts)
    log = open(root / "server.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "embedding_cpp_tpu_torch.runtime.server", "-m", str(q4_path),
         "-m", f"minilm-f16={root / 'f16.gguf'}", "--host", "127.0.0.1", "--port", str(port),
         "--http-port", str(http_port)],
        cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT)
    try:
        s = None
        while s is None:
            check(proc.poll() is None,
                  f"server exited: {(root / 'server.log').read_text()[-2000:]}")
            check(time.perf_counter() - t0 < 300, "server did not listen within 300 s")
            try:
                s = socket.create_connection(("127.0.0.1", port), 1.0)
            except OSError:
                time.sleep(0.1)
        with s:
            s.settimeout(120)
            _recv(s, 4)
            s.sendall(b"TPE2" + struct.pack("<I", len(texts)) + body)
            (count,) = struct.unpack("<I", _recv(s, 4))
            vecs = np.frombuffer(_recv(s, 4 * count * config.n_embd),
                                 np.float32).reshape(count, -1)
            first_reply_s = time.perf_counter() - t0
            replies = [vecs]
            for _ in range(2):
                s.sendall(b"TPE2" + struct.pack("<I", len(texts)) + body)
                (count,) = struct.unpack("<I", _recv(s, 4))
                replies.append(np.frombuffer(_recv(s, 4 * count * config.n_embd),
                                             np.float32).reshape(count, -1))
        http_replies = {}
        for model in (None, "minilm-f16"):
            payload = {"input": texts, "encoding_format": "base64",
                       **({"model": model} if model else {})}
            status, body_out = _http(http_port, "POST", "/v1/embeddings", payload)
            check(status == 200, f"HTTP {model}: {status} {body_out[:500]}")
            http_replies[model] = _b64_vectors(json.loads(body_out))
        status, models = _http(http_port, "GET", "/v1/models")
        served = sorted(m["id"] for m in json.loads(models)["data"])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        log.close()
    server_diff = max(float(np.abs(r - want).max()) for r in replies)
    http_diff = float(np.abs(http_replies[None] - want).max())
    f16_cos = _min_cos(http_replies["minilm-f16"], want_f16)
    emit({"phase": "formats_server", "first_reply_s": first_reply_s, "replies": len(replies),
          "texts": len(texts), "max_abs_diff_vs_int8_engine": server_diff,
          "http_max_abs_diff_vs_int8_engine": http_diff,
          "http_second_model_min_cosine": f16_cos, "models_served": served,
          "exit_code": proc.returncode})
    check(server_diff <= spread, f"server replies differ from the int8 engine: {server_diff}")
    check(http_diff <= spread, f"HTTP replies differ from the int8 engine: {http_diff}")
    check(f16_cos >= COSINE_SERVER, f"the second model's HTTP replies: cosine {f16_cos}")
    check(len(served) == 2 and "minilm-f16" in served, f"models served {served}")
    counts = {k: counts["auto"][k] + counts["never"][k] for k in counters}
    # the Q4_0 and f16 files stay for the native, http and cli phases
    return counts, {"tmp": tmp, "q4_0": q4_path, "f16": root / "f16.gguf"}


def _modernbert_counts_ok(counts: dict, forwards: int, packing: str, what: str) -> None:
    """Per forward at S <= 1024: 154 K1 launches (22 with the prologue), 8
    global layers on K2 (packed) or K3, 14 local layers on K4."""
    glob, loc = (("attn_bse_packed", "attn_bse_bias_packed") if packing == "auto"
                 else ("attn_bse_keybias", "attn_bse_bias"))
    check(counts["q4_matmul"] == 154 * forwards and counts["q4_matmul_2d"] == 0,
          f"{what}: K1 {counts}")
    check(counts["q4_matmul_prologue"] == 22 * forwards, f"{what}: K1 prologue {counts}")
    check(counts[glob] == 8 * forwards and counts[loc] == 14 * forwards,
          f"{what}: attention {counts}")
    check(sum(counts[k] for k in ATTENTION) == 22 * forwards, f"{what}: attention {counts}")


def phase_modernbert_main(counters, token_lists) -> tuple:
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import MODERNBERT_BASE, ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch, bert_embed_packed

    # the `modernbert-base` preset: full width and depth, synthetic 1000-word vocab
    config = replace(MODERNBERT_BASE, n_vocab=1000, name="modernbert-base-synthetic")
    opts = ComputeOptions(dtype="bfloat16")
    base = Engine.synthetic(config, "q4_0", seed=0, opts=opts, device="cuda")
    engines = {packing: Engine(base.params, config, base.tokenizer, base.special_ids,
                               opts=opts, device="cuda", packing=packing)
               for packing in ("auto", "never")}
    launches, outs = {}, {}
    for packing, eng in engines.items():
        reset_counts(counters)
        outs[packing] = eng.embed_tokens(token_lists)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        forwards = _expected_forwards(eng, token_lists)
        launches[packing] = counts
        emit({"phase": "modernbert_launches", "packing": packing, "forwards": forwards,
              "launches": counts})
        _modernbert_counts_ok(counts, forwards, packing, f"modernbert {packing}")
        out = outs[packing]
        norms = np.linalg.norm(out, axis=-1)
        check(np.isfinite(out).all() and out.shape == (len(token_lists), 768),
              f"modernbert {packing}: output {out.shape}")
        check(np.abs(norms - 1.0).max() <= 1e-3, f"modernbert {packing}: norms")

    best = {key: float("inf") for key in engines}
    for _ in range(5):
        for key, eng in engines.items():
            t0 = time.perf_counter()
            eng.embed_tokens(token_lists)
            best[key] = min(best[key], time.perf_counter() - t0)

    ids, mask, (pids, seg, pos) = _forward_inputs(config, seed=1)
    with torch.inference_mode():
        # a forward is ~700 launches: spin long enough to queue them
        plain_ms = gpu_ms(lambda: bert_embed_batch(base.params, ids, mask, config, opts),
                          samples=5, reps=2, spin=500_000_000)
        packed_ms = gpu_ms(lambda: bert_embed_packed(base.params, pids, seg, pos, config,
                                                     opts, n_seg=64),
                           samples=5, reps=2, spin=500_000_000)
    emit({"phase": "modernbert_main", "model": config.name, "weights": "q4_0",
          "activations": "bfloat16", "sentences": len(token_lists),
          "tokens": sum(len(t) for t in token_lists),
          "sentences_per_sec": {p: len(token_lists) / t for p, t in best.items()},
          "sentences_per_sec_packed": len(token_lists) / best["auto"],
          "sentences_per_sec_plain": len(token_lists) / best["never"],
          "forward_ms_in_device_b32_s512": plain_ms,
          "packed_forward_ms_in_device_b32_s512": packed_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    total = {name: sum(c[name] for c in launches.values()) for name in counters}
    return base, outs, total, (base.params, config, pids, seg, pos)


def _documents(n: int, s: int, seed: int, special) -> list[list[int]]:
    """Synthetic documents of exactly s tokens: [CLS] ids [SEP]."""
    rng = np.random.default_rng(seed)
    return [[special.cls] + rng.integers(4, 1000, s - 2).tolist() + [special.sep]
            for _ in range(n)]


def phase_modernbert_long(counters, base, out_dir) -> dict:
    """8 documents of 8192 tokens: one [8, 8192] forward, 8 global layers on
    K5 and 14 local layers on K7; its kernel times under torch.profiler."""
    import torch

    from embedding_cpp_tpu_torch.models import ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch

    docs = _documents(8, 8192, seed=5, special=base.special_ids)
    check(_expected_forwards(base, docs) == 1, "8 documents of 8192 tokens: one forward")
    reset_counts(counters)
    out = base.embed_tokens(docs)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    emit({"phase": "modernbert_long_launches", "forwards": 1, "launches": counts})
    check(counts["q4_matmul"] == 154 and counts["q4_matmul_prologue"] == 22
          and counts["q4_matmul_2d"] == 0, f"long: K1 {counts}")
    check(counts["attn_long"] == 8 and counts["attn_local"] == 14, f"long: {counts}")
    check(sum(counts[k] for k in ATTENTION) == 22, f"long: attention {counts}")
    norms = np.linalg.norm(out, axis=-1)
    check(np.isfinite(out).all() and np.abs(norms - 1.0).max() <= 1e-3, "long: output")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        base.embed_tokens(docs)
        best = min(best, time.perf_counter() - t0)
    dev = torch.device("cuda")
    ids = torch.tensor(docs, dtype=torch.int32, device=dev)
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        fwd_ms = gpu_ms(lambda: bert_embed_batch(base.params, ids, mask, base.config,
                                                 ComputeOptions(dtype="bfloat16")),
                        samples=3, reps=1, spin=500_000_000)
        _, rows, table = _profiled(lambda: bert_embed_batch(
            base.params, ids, mask, base.config, ComputeOptions(dtype="bfloat16")))
    _save(out_dir, "profile_modernbert_long_forward.txt", table)
    emit({"phase": "profile", "model": base.config.name, "what": "forward [8, 8192]",
          "device_busy_ms": sum(r[1] for r in rows) / 1e3,
          "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                  for k, us, n in rows[:8]]})
    emit({"phase": "modernbert_long", "documents": len(docs), "tokens_per_document": 8192,
          "documents_per_sec": len(docs) / best, "tokens_per_sec": 8 * 8192 / best,
          "forward_ms_in_device_b8_s8192": fwd_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts


def phase_modernbert_vs_cpu(counters, base, outs, token_lists) -> dict:
    """The bf16 GPU path against the port's own f32 CPU path (plain
    versions) on the same weights: 256 corpus sentences, and one document
    of 2048 tokens, which runs K5/K7 on the card (one, not two since PR 15:
    the CPU's plain long-row attention is most of the phase's time)."""
    import torch

    from embedding_cpp_tpu_torch import Engine

    cpu = Engine(base.params, base.config, base.tokenizer, base.special_ids, device="cpu")
    ref = cpu.embed_tokens(token_lists[:256])

    cos = {f"sentences/{p}": _min_cos(outs[p][:256], ref) for p in outs}
    docs = _documents(1, 2048, seed=6, special=base.special_ids)
    reset_counts(counters)
    got = base.embed_tokens(docs)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    check(counts["attn_long"] == 8 and counts["attn_local"] == 14, f"2048: {counts}")
    cos["documents_2048"] = _min_cos(got, cpu.embed_tokens(docs))
    emit({"phase": "modernbert_vs_cpu", "sentences": 256, "documents": len(docs),
          "document_tokens": 2048, "min_cosine": cos, "threshold": COSINE_VS_CPU,
          "launches_2048": counts})
    check(min(cos.values()) >= COSINE_VS_CPU, f"modernbert cosine vs CPU {cos}")
    return counts


def _rerank_pairs(n: int, seed: int) -> list[tuple[str, str]]:
    """Query/passage pairs with the MS MARCO passage-ranking profile: a
    query of 8-12 words, a passage of 60 +- 20 words."""
    from embedding_cpp_tpu_torch.tokenizer.testvocab import _COMMON_WORDS

    rng = np.random.default_rng(seed)
    words = np.array(_COMMON_WORDS)
    return [(" ".join(rng.choice(words, size=int(rng.integers(8, 13)))),
             " ".join(rng.choice(words, size=max(20, int(rng.normal(60, 20))))))
            for _ in range(n)]


def _deberta_counts_ok(counts: dict, packed: int, plain: int, what: str) -> None:
    """Per forward: 96 K1 launches (six linears and the two projections of
    the relative table, 12 layers), 12 K10 (packed) or 12 K9 (plain)."""
    forwards = packed + plain
    check(counts["q4_matmul"] == 96 * forwards and counts["q4_matmul_prologue"] == 0
          and counts["q4_matmul_2d"] == 0, f"{what}: K1 {counts}")
    check(counts["deberta_attn_packed"] == 12 * packed and counts["deberta_attn"] == 12 * plain,
          f"{what}: attention {counts}")
    check(sum(counts[k] for k in ATTENTION) == 12 * forwards, f"{what}: attention {counts}")


def _pearson(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.corrcoef(a, b)[0, 1])


def _logits_vs_cpu(base, pair_ids, pair_types, logits, what: str, n: int = 64,
                   spread_scaled: bool = False) -> dict:
    """The first `n` pairs' logits of the card's bf16 path (`logits`) and of
    its f32 path against the port's CPU path on the same weights, f32 and
    bf16: the cross-encoder bars (f32 Pearson and the same top-1; bf16
    Pearson against the f32 CPU path, Pearson and max error against the
    CPU's bf16 path; with `spread_scaled`, the two bf16 Pearson bars at the
    f32 logits' spread, `BARS_LOGIT_STD`).  Returns the readings."""
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions

    def engine(device, dtype="float32"):
        return Engine(base.params, base.config, base.tokenizer, base.special_ids,
                      opts=ComputeOptions(dtype=dtype), device=device)

    ids, types = pair_ids[:n], pair_types[:n]
    got = logits[:n]
    got_f32 = engine("cuda").score_token_pairs(ids, types)
    ref_f32 = engine("cpu").score_token_pairs(ids, types)
    ref_bf16 = engine("cpu", "bfloat16").score_token_pairs(ids, types)
    std = float(np.std(ref_f32))
    k = max(1.0, (BARS_LOGIT_STD / std) ** 2) if spread_scaled else 1.0
    bars = {"f32": PEARSON_F32, "bf16": 1.0 - (1.0 - PEARSON_BF16) * k,
            "bf16_vs_cpu_bf16": 1.0 - (1.0 - PEARSON_BF16_VS_BF16) * k}
    vs = {"pairs": n, "logit_std": std,
          "f32_pearson": _pearson(got_f32, ref_f32),
          "f32_top1": [int(np.argmax(got_f32)), int(np.argmax(ref_f32))],
          "f32_max_abs_logit_err": float(np.abs(got_f32 - ref_f32).max()),
          "bf16_pearson": _pearson(got, ref_f32),
          "bf16_max_abs_logit_err": float(np.abs(got - ref_f32).max()),
          "bf16_top1": int(np.argmax(got)),
          "bf16_pearson_vs_cpu_bf16": _pearson(got, ref_bf16),
          "bf16_max_abs_logit_err_vs_cpu_bf16": float(np.abs(got - ref_bf16).max()),
          "pearson_thresholds": bars,
          "max_abs_logit_err_bf16_vs_cpu_bf16": LOGIT_ERR_BF16_VS_BF16}
    check(vs["f32_pearson"] >= PEARSON_F32 and vs["f32_top1"][0] == vs["f32_top1"][1],
          f"{what} f32 logits {vs}")
    check(vs["bf16_pearson"] >= bars["bf16"], f"{what} bf16 logits {vs}")
    check(vs["bf16_pearson_vs_cpu_bf16"] >= bars["bf16_vs_cpu_bf16"]
          and vs["bf16_max_abs_logit_err_vs_cpu_bf16"] <= LOGIT_ERR_BF16_VS_BF16,
          f"{what} bf16 logits vs the CPU's bf16 path {vs}")
    return vs


def phase_deberta_main(counters, token_lists, out_dir) -> tuple:
    """DeBERTa-v3-base (Q4_0 weights from seed 0, bf16 activations) with
    mxbai-rerank-base-v1's head: embeddings over the corpus, packed and
    plain; cross-encoder scores of 256 query/passage pairs."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import DEBERTA_V3_BASE, ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch, bert_embed_packed
    from embedding_cpp_tpu_torch.runtime.batching import pack_batches

    # full width and depth; the one cut is the vocab (1000 synthetic words)
    config = replace(DEBERTA_V3_BASE, n_vocab=1000, n_labels=1, head_activation="gelu",
                     name="deberta-v3-base-synthetic")
    opts = ComputeOptions(dtype="bfloat16")
    base = Engine.synthetic(config, "q4_0", seed=0, opts=opts, device="cuda")
    engines = {packing: Engine(base.params, config, base.tokenizer, base.special_ids,
                               opts=opts, device="cuda", packing=packing)
               for packing in ("auto", "never")}
    launches, outs = {}, {}
    for packing, eng in engines.items():
        reset_counts(counters)
        outs[packing] = eng.embed_tokens(token_lists)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        packed, plain = _planned_forwards(eng, token_lists)
        launches[packing] = counts
        emit({"phase": "deberta_launches", "packing": packing, "packed_forwards": packed,
              "plain_forwards": plain, "launches": counts})
        _deberta_counts_ok(counts, packed, plain, f"deberta {packing}")
        check(counts["deberta_attn_packed" if packing == "auto" else "deberta_attn"] > 0,
              f"deberta {packing}: {counts}")
        out = outs[packing]
        norms = np.linalg.norm(out, axis=-1)
        check(np.isfinite(out).all() and out.shape == (len(token_lists), 768),
              f"deberta {packing}: output {out.shape}")
        check(np.abs(norms - 1.0).max() <= 1e-3, f"deberta {packing}: norms")

    best = {key: float("inf") for key in engines}
    for _ in range(5):
        for key, eng in engines.items():
            t0 = time.perf_counter()
            eng.embed_tokens(token_lists)
            best[key] = min(best[key], time.perf_counter() - t0)

    # cross-encoder: 256 pre-framed pairs through the length buckets
    pairs = _rerank_pairs(256, seed=8)
    pair_ids, pair_types = base.tokenize_pairs(pairs)
    shapes = [list(b.ids.shape) for b in base.score_plan(pair_ids)]
    forwards = len(shapes)
    reset_counts(counters)
    logits = base.score_token_pairs(pair_ids, pair_types)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    emit({"phase": "deberta_score_launches", "pairs": len(pairs), "plain_forwards": forwards,
          "batch_shapes": shapes, "launches": counts})
    _deberta_counts_ok(counts, 0, forwards, "deberta score")
    launches["score"] = counts
    check(logits.shape == (len(pairs),) and np.isfinite(logits).all(), "deberta logits")
    best_pairs = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        base.score_token_pairs(pair_ids, pair_types)
        best_pairs = min(best_pairs, time.perf_counter() - t0)
    wall_ms, rows, table = _profiled(lambda: base.score_token_pairs(pair_ids, pair_types))
    _save(out_dir, "profile_deberta_score_token_pairs.txt", table)
    busy_ms = sum(r[1] for r in rows) / 1e3
    emit({"phase": "profile", "model": config.name, "what": "score_token_pairs, 256 pairs",
          "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
          "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                  for k, us, n in rows[:6]]})

    # the port's CPU path on the same weights: f32 (and bf16, reported); the
    # logits of 64 pairs also through the card's f32 path
    cpu = Engine(base.params, config, base.tokenizer, base.special_ids, device="cpu")
    ref = cpu.embed_tokens(token_lists[:256])
    cos = {p: _min_cos(outs[p][:256], ref) for p in outs}
    vs_cpu = {"sentences": 256, "min_cosine": cos, "threshold": COSINE_VS_CPU,
              **_logits_vs_cpu(base, pair_ids, pair_types, logits, "deberta")}
    emit({"phase": "deberta_vs_cpu", **vs_cpu})
    check(min(cos.values()) >= COSINE_VS_CPU, f"deberta cosine vs CPU {cos}")
    # K9 at the shapes of the plain corpus forwards and the score forwards
    plain_shapes = [tuple(b.ids.shape) for b in pack_batches(
        token_lists, base.special_ids.pad, seq_buckets=base.seq_buckets,
        batch_buckets=base.batch_buckets, max_seq=config.n_ctx,
        max_tokens=base.max_batch_tokens)]
    phase_kernels_deberta_shapes(plain_shapes + [tuple(s) for s in shapes],
                                 config.rel_attn_buckets, config.rel_attn_max_dist)

    ids, mask, (pids, seg, pos) = _forward_inputs(config, seed=2)
    with torch.inference_mode():
        # a forward is ~500 launches: spin long enough to queue them
        plain_ms = gpu_ms(lambda: bert_embed_batch(base.params, ids, mask, config, opts),
                          samples=5, reps=2, spin=500_000_000)
        packed_ms = gpu_ms(lambda: bert_embed_packed(base.params, pids, seg, pos, config,
                                                     opts, n_seg=64),
                           samples=5, reps=2, spin=500_000_000)
    emit({"phase": "deberta_main", "model": config.name, "weights": "q4_0",
          "activations": "bfloat16", "sentences": len(token_lists),
          "tokens": sum(len(t) for t in token_lists),
          "sentences_per_sec": {p: len(token_lists) / t for p, t in best.items()},
          "sentences_per_sec_packed": len(token_lists) / best["auto"],
          "sentences_per_sec_plain": len(token_lists) / best["never"],
          "pairs": len(pairs), "pair_tokens": sum(len(t) for t in pair_ids),
          "pairs_per_sec": len(pairs) / best_pairs,
          "forward_ms_in_device_b32_s512": plain_ms,
          "packed_forward_ms_in_device_b32_s512": packed_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    total = {name: sum(c[name] for c in launches.values()) for name in counters}
    return base, total, (base.params, config, pids, seg, pos)


def _nomic_counts_ok(counts: dict, attention: dict, what: str) -> None:
    """Per forward: 84 K1 launches (seven linears, 12 layers), 12 with the
    prologue (the SwiGLU gate), and 12 of the routed attention kernel;
    `attention` maps each routed counter to its forwards."""
    forwards = sum(attention.values())
    check(counts["q4_matmul"] == 84 * forwards and counts["q4_matmul_2d"] == 0
          and counts["q4_matmul_prologue"] == 12 * forwards, f"{what}: K1 {counts}")
    check(all(counts[k] == 12 * n for k, n in attention.items())
          and sum(counts[k] for k in ATTENTION) == 12 * forwards, f"{what}: attention {counts}")


def _run_counted(counters, eng, token_lists, attention: dict, what: str) -> tuple:
    """One embed_tokens call with every count set to 0 just before it and
    read just after; checks the launches and the output's shape and norms."""
    import torch

    reset_counts(counters)
    out = eng.embed_tokens(token_lists)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    emit({"phase": "nomic_launches", "what": what, "forwards": attention, "launches": counts})
    _nomic_counts_ok(counts, attention, what)
    check(all(counts[k] > 0 for k in attention), f"{what}: {counts}")
    norms = np.linalg.norm(out, axis=-1)
    check(np.isfinite(out).all() and out.shape == (len(token_lists), eng.n_embd)
          and np.abs(norms - 1.0).max() <= 1e-3, f"{what}: output {out.shape}")
    return out, counts


def _best_s(fn, runs: int) -> float:
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _min_cos(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.min(np.sum(a * b, -1) / np.linalg.norm(a, axis=-1)
                        / np.linalg.norm(b, axis=-1)))


def phase_nomic_main(counters, token_lists) -> tuple:
    """nomic-embed-text-v1.5 at full width and depth (Q4_0 weights from seed
    0, bf16 activations) over the corpus at the default pack_seq 512:
    packed (K2) and plain (K3)."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import NOMIC_EMBED, ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch, bert_embed_packed

    # full width and depth; the one cut is the vocab (1000 synthetic words)
    config = replace(NOMIC_EMBED, n_vocab=1000, name="nomic-embed-text-v1.5-synthetic")
    opts = ComputeOptions(dtype="bfloat16")
    base = Engine.synthetic(config, "q4_0", seed=0, opts=opts, device="cuda")
    engines = {packing: Engine(base.params, config, base.tokenizer, base.special_ids,
                               opts=opts, device="cuda", packing=packing)
               for packing in ("auto", "never")}
    launches, outs = {}, {}
    for packing, eng in engines.items():
        packed, plain = _planned_forwards(eng, token_lists)
        routes = {k: n for k, n in (("attn_bse_packed", packed),
                                    ("attn_bse_keybias", plain)) if n}
        outs[packing], launches[packing] = _run_counted(counters, eng, token_lists, routes,
                                                        f"corpus, packing {packing}")
    best = {p: _best_s(lambda e=eng: e.embed_tokens(token_lists), 3)
            for p, eng in engines.items()}

    ids, mask, (pids, seg, pos) = _forward_inputs(config, seed=3)
    with torch.inference_mode():
        plain_ms = gpu_ms(lambda: bert_embed_batch(base.params, ids, mask, config, opts),
                          samples=5, reps=2, spin=500_000_000)
        packed_ms = gpu_ms(lambda: bert_embed_packed(base.params, pids, seg, pos, config,
                                                     opts, n_seg=64),
                           samples=5, reps=2, spin=500_000_000)
    emit({"phase": "nomic_main", "model": config.name, "weights": "q4_0",
          "activations": "bfloat16", "sentences": len(token_lists),
          "tokens": sum(len(t) for t in token_lists),
          "sentences_per_sec_packed": len(token_lists) / best["auto"],
          "sentences_per_sec_plain": len(token_lists) / best["never"],
          "forward_ms_in_device_b32_s512": plain_ms,
          "packed_forward_ms_in_device_b32_s512": packed_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    total = {name: sum(c[name] for c in launches.values()) for name in counters}
    return base, outs, total


def _chunks(n: int, lo: int, hi: int, seed: int, special) -> list[list[int]]:
    """n token lists of lo..hi tokens: [CLS] ids [SEP] (RAG chunks)."""
    rng = np.random.default_rng(seed)
    return [[special.cls] + rng.integers(4, 1000, int(m) - 2).tolist() + [special.sep]
            for m in rng.integers(lo, hi + 1, n)]


def phase_nomic_chunks(counters, base, out_dir) -> tuple:
    """512 RAG chunks of 128-512 tokens (seed 0) through Engine(pack_seq=
    2048): auto packing puts every chunk in rows of 2048 with the bound
    512, so every layer takes the windowed K6 (wmax 1408).  Reports the
    padded token slots of the plan; profiles the [8, 2048] forward and the
    whole call."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models.bert import bert_embed_packed
    from embedding_cpp_tpu_torch.ops.attention import packed_window_tiles
    from embedding_cpp_tpu_torch.runtime.engine import segment_bound

    eng = Engine(base.params, base.config, base.tokenizer, base.special_ids, opts=base.opts,
                 device="cuda", pack_seq=2048)
    chunks = _chunks(512, 128, 512, seed=0, special=base.special_ids)
    plan = _packed_plan(eng, chunks)
    bounds = [segment_bound(pb) for pb in plan]
    check(sum(len(pb.orig) for pb in plan) == len(chunks) and set(bounds) == {512}
          and packed_window_tiles(2048, 512) == (256, 1408), f"chunk plan {bounds}")
    tokens = sum(len(t) for t in chunks)
    slots = sum(pb.ids.size for pb in plan)
    _, counts = _run_counted(counters, eng, chunks, {"attn_seg_window": len(plan)}, "chunks")
    best = _best_s(lambda: eng.embed_tokens(chunks), 3)
    pb = plan[0]
    dev = torch.device("cuda")
    ids, seg, pos = (torch.from_numpy(a[:8]).to(dev) for a in (pb.ids, pb.seg, pb.pos))

    def forward():
        return bert_embed_packed(base.params, ids, seg, pos, base.config, base.opts,
                                 n_seg=eng.pack_segs, max_seg_len=512)

    with torch.inference_mode():
        fwd_ms = gpu_ms(forward, samples=5, reps=2, spin=500_000_000)
        _, rows, table = _profiled(forward)
    _save(out_dir, "profile_nomic_packed_forward_b8_s2048.txt", table)
    emit({"phase": "profile", "model": base.config.name, "what": "packed forward [8, 2048]",
          "device_busy_ms": sum(r[1] for r in rows) / 1e3,
          "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                  for k, us, n in rows[:8]]})
    wall_ms, rows, table = _profiled(lambda: eng.embed_tokens(chunks))
    _save(out_dir, "profile_nomic_chunks_embed_tokens.txt", table)
    busy_ms = sum(r[1] for r in rows) / 1e3
    emit({"phase": "profile", "model": base.config.name,
          "what": "embed_tokens, 512 chunks, pack_seq 2048",
          "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms)})
    emit({"phase": "nomic_chunks", "chunks": len(chunks), "tokens": tokens,
          "pack_seq": eng.pack_seq, "batch_shapes": [list(b.ids.shape) for b in plan],
          "token_slots": slots, "padded_token_slots": slots - tokens,
          "max_seg_len": 512, "chunks_per_sec": len(chunks) / best,
          "packed_forward_ms_in_device_b8_s2048": fwd_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return chunks, counts


def phase_nomic_documents(counters, base) -> dict:
    """32 documents of 600-1400 tokens through Engine(pack_seq=2048,
    packing="always"): the bound is 2048, so every key (K6a); and 8
    documents of 8192 tokens, plain, through K5 with the NTK-scaled base."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch
    from embedding_cpp_tpu_torch.runtime.engine import segment_bound

    eng = Engine(base.params, base.config, base.tokenizer, base.special_ids, opts=base.opts,
                 device="cuda", pack_seq=2048, packing="always")
    docs = _chunks(32, 600, 1400, seed=1, special=base.special_ids)
    plan = _packed_plan(eng, docs)
    check(sum(len(pb.orig) for pb in plan) == len(docs)
          and {segment_bound(pb) for pb in plan} == {2048}, "document plan")
    _, counts = _run_counted(counters, eng, docs, {"attn_seg": len(plan)}, "documents, packed")
    best = _best_s(lambda: eng.embed_tokens(docs), 3)

    long_docs = _documents(8, 8192, seed=7, special=base.special_ids)
    check(_planned_forwards(base, long_docs) == (0, 1), "8 documents of 8192: one forward")
    _, long_counts = _run_counted(counters, base, long_docs, {"attn_long": 1},
                                  "documents of 8192 tokens")
    best_long = _best_s(lambda: base.embed_tokens(long_docs), 2)
    dev = torch.device("cuda")
    ids = torch.tensor(long_docs, dtype=torch.int32, device=dev)
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        fwd_ms = gpu_ms(lambda: bert_embed_batch(base.params, ids, mask, base.config, base.opts),
                        samples=3, reps=1, spin=500_000_000)
    emit({"phase": "nomic_documents", "documents": len(docs),
          "tokens": sum(len(t) for t in docs), "pack_seq": 2048, "packing": "always",
          "batch_shapes": [list(b.ids.shape) for b in plan],
          "documents_per_sec": len(docs) / best,
          "long_documents": len(long_docs), "tokens_per_long_document": 8192,
          "long_documents_per_sec": len(long_docs) / best_long,
          "forward_ms_in_device_b8_s8192": fwd_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    return {k: counts[k] + long_counts[k] for k in counts}


def phase_nomic_vs_cpu(counters, base, outs, token_lists, chunks) -> dict:
    """The bf16 card path against the port's f32 CPU path (plain versions)
    on the same weights: 256 corpus sentences (packed and plain), 16
    chunks packed in rows of 2048 (K6b), a document of 2048 tokens (K5)."""
    import torch

    from embedding_cpp_tpu_torch import Engine

    def cpu_engine(**kw):
        return Engine(base.params, base.config, base.tokenizer, base.special_ids,
                      device="cpu", **kw)

    ref = cpu_engine().embed_tokens(token_lists[:256])
    cos = {f"sentences/{p}": _min_cos(outs[p][:256], ref) for p in outs}
    kw = {"pack_seq": 2048, "packing": "always"}
    gpu = Engine(base.params, base.config, base.tokenizer, base.special_ids, opts=base.opts,
                 device="cuda", **kw)
    few = chunks[:16]
    got, counts = _run_counted(counters, gpu, few, {"attn_seg_window": len(_packed_plan(gpu, few))},
                               "16 chunks")
    cos["chunks_packed_2048"] = _min_cos(got, cpu_engine(**kw).embed_tokens(few))
    docs = _documents(1, 2048, seed=8, special=base.special_ids)
    got, doc_counts = _run_counted(counters, base, docs, {"attn_long": 1}, "a document of 2048")
    cos["documents_2048"] = _min_cos(got, cpu_engine().embed_tokens(docs))
    emit({"phase": "nomic_vs_cpu", "sentences": 256, "chunks": len(few), "documents": len(docs),
          "document_tokens": 2048, "min_cosine": cos, "threshold": COSINE_VS_CPU})
    check(min(cos.values()) >= COSINE_VS_CPU, f"nomic cosine vs CPU {cos}")
    torch.cuda.empty_cache()
    return {k: counts[k] + doc_counts[k] for k in counts}


def _planned_shapes(eng, token_lists) -> tuple[list, list]:
    """([B, S] of each packed forward, [B, S] of each plain forward) that
    the engine's plan launches for the lists."""
    from embedding_cpp_tpu_torch.runtime.batching import pack_batches

    rest = sorted(set(range(len(token_lists))) - set(eng._pack_plan(token_lists)))
    plain = pack_batches([token_lists[i] for i in rest], eng.special_ids.pad,
                         seq_buckets=eng.seq_buckets, batch_buckets=eng.batch_buckets,
                         max_seq=eng.config.n_ctx, max_tokens=eng.max_batch_tokens)
    return ([pb.ids.shape for pb in _packed_plan(eng, token_lists)],
            [b.ids.shape for b in plain])


def _route_counts(config, shapes, dtype, qtype: str = "Q8_0") -> tuple[int, int]:
    """(K1, K8) launches that q4_matmul's route gives the `qtype` linears of
    every layer (q, k, v, o, up, the gate of a gated FFN, down) in one
    forward of each [B, S] batch."""
    from embedding_cpp_tpu_torch.gguf import GGMLType
    from embedding_cpp_tpu_torch.ops.q4_matmul import route

    e, a, f = config.n_embd, config.attn_inner, config.n_ff
    linears = [(e, a)] * 3 + [(a, e)] + [(e, f)] * (1 + config.ffn_gated) + [(f, e)]
    k1 = k8 = 0
    for b, s in shapes:
        for k, n in linears:
            if route(b * s, k, n, GGMLType[qtype], dtype).kernel == "2d":
                k8 += config.n_layer
            else:
                k1 += config.n_layer
    return k1, k8


def _bge_counts_ok(counts: dict, eng, token_lists, dtype, what: str) -> int:
    """Per forward 96 K1 + 48 K8 (the FFN) + 24 attention launches, exactly
    what the route gives every planned batch.  Returns the forwards."""
    packed, plain = _planned_shapes(eng, token_lists)
    return _graph_counts_ok(counts, eng.config, packed, plain, what, "Q8_0", dtype,
                            k8_linears=2)


def phase_bge_main(counters, token_lists) -> tuple:
    """bge-large-en-v1.5 at full width and depth (1024 wide, 24 layers, 16
    heads of 64, FFN 4096, CLS pooling; Q8_0 weights from seed 0, bf16
    activations) over the corpus, packed (K2) and plain (K3): K1 on q, k,
    v, o and K8 on the FFN, sentences/s, in-device forward ms at [32, 512]."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import BGE_LARGE_EN, ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch, bert_embed_packed

    # full width and depth; the one cut is the vocab (1000 synthetic words)
    config = replace(BGE_LARGE_EN, n_vocab=1000, name="bge-large-en-v1.5-synthetic")
    opts = ComputeOptions(dtype="bfloat16")
    t0 = time.perf_counter()
    base = Engine.synthetic(config, "q8_0", seed=0, opts=opts, device="cuda")
    build_s = time.perf_counter() - t0
    engines = {packing: Engine(base.params, config, base.tokenizer, base.special_ids,
                               opts=opts, device="cuda", packing=packing)
               for packing in ("auto", "never")}
    launches, outs, forwards = {}, {}, {}
    for packing, eng in engines.items():
        reset_counts(counters)
        outs[packing] = eng.embed_tokens(token_lists)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        launches[packing] = counts
        forwards[packing] = _bge_counts_ok(counts, eng, token_lists, torch.bfloat16,
                                           f"bge {packing}")
        emit({"phase": "bge_launches", "packing": packing, "forwards": forwards[packing],
              "launches": counts})
        check(counts["attn_bse_packed" if packing == "auto" else "attn_bse_keybias"] > 0,
              f"bge {packing}: {counts}")
        out = outs[packing]
        norms = np.linalg.norm(out, axis=-1)
        check(np.isfinite(out).all() and out.shape == (len(token_lists), 1024)
              and np.abs(norms - 1.0).max() <= 1e-3, f"bge {packing}: output {out.shape}")
    best = {p: _best_s(lambda e=eng: e.embed_tokens(token_lists), 3)
            for p, eng in engines.items()}

    ids, mask, (pids, seg, pos) = _forward_inputs(config, seed=15)
    with torch.inference_mode():
        # a forward is ~400 launches of ~300 ms: spin long enough to queue two
        plain_ms = gpu_ms(lambda: bert_embed_batch(base.params, ids, mask, config, opts),
                          samples=3, reps=2, spin=1_000_000_000)
        packed_ms = gpu_ms(lambda: bert_embed_packed(base.params, pids, seg, pos, config,
                                                     opts, n_seg=64),
                           samples=3, reps=2, spin=1_000_000_000)
    emit({"phase": "bge_main", "model": config.name, "weights": "q8_0",
          "activations": "bfloat16", "params_build_s": build_s,
          "sentences": len(token_lists), "tokens": sum(len(t) for t in token_lists),
          "forwards": forwards,
          "sentences_per_sec_packed": len(token_lists) / best["auto"],
          "sentences_per_sec_plain": len(token_lists) / best["never"],
          "forward_ms_in_device_b32_s512": plain_ms,
          "packed_forward_ms_in_device_b32_s512": packed_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    total = {name: sum(c[name] for c in launches.values()) for name in counters}
    return base, outs, total, (base.params, config, pids, seg, pos)


def phase_bge_vs_cpu(counters, base, outs, token_lists) -> dict:
    """The card's bf16 path (packed and plain) and its f32 path (K8's f32
    form on every FFN linear) against the port's f32 CPU path on the same
    Q8_0 weights, 256 corpus sentences."""
    import torch

    from embedding_cpp_tpu_torch import Engine

    few = token_lists[:256]
    ref = Engine(base.params, base.config, base.tokenizer, base.special_ids,
                 device="cpu").embed_tokens(few)
    cos = {f"bf16/{p}": _min_cos(outs[p][:256], ref) for p in outs}
    gpu_f32 = Engine(base.params, base.config, base.tokenizer, base.special_ids, device="cuda")
    reset_counts(counters)
    got = gpu_f32.embed_tokens(few)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    _bge_counts_ok(counts, gpu_f32, few, torch.float32, "bge f32")
    cos["f32/auto"] = _min_cos(got, ref)
    emit({"phase": "bge_vs_cpu", "sentences": len(few), "min_cosine": cos,
          "threshold": COSINE_VS_CPU, "f32_launches": counts})
    check(min(cos.values()) >= COSINE_VS_CPU, f"bge cosine vs CPU {cos}")
    torch.cuda.empty_cache()
    return counts


def _graph_counts_ok(counts: dict, config, packed: list, plain: list, what: str,
                     qtype: str = "Q4_0", dtype=None, k8_linears: int = 0) -> int:
    """The forwards of the BERT graph (BERT, RoBERTa/XLM-R, DistilBERT,
    ELECTRA, MPNet, ALBERT) and of T5 over the planned [B, S] batches: per
    layer six linears (seven with a gated FFN, whose down projection takes
    K1's prologue), K1's except the `k8_linears` the route gives K8
    (bge-large's Q8_0 FFN), exactly as q4_matmul's route gives every batch,
    and one attention launch: K2 (packed) or K3 (plain), or K4's packed or
    plain form under MPNet's and T5's relative bias; no fused tail.
    Returns the forwards."""
    import torch

    k1, k8 = _route_counts(config, packed + plain, dtype or torch.bfloat16, qtype)
    forwards, layers = len(packed) + len(plain), config.n_layer
    n_linears = 6 + config.ffn_gated
    check((k1, k8) == ((n_linears - k8_linears) * layers * forwards,
                       k8_linears * layers * forwards),
          f"{what}: the route gives {k1}/{k8}")
    check(counts["q4_matmul"] == k1 and counts["q4_matmul_2d"] == k8
          and counts["q4_matmul_prologue"] == config.ffn_gated * layers * forwards
          and counts["q4_matmul_ln"] == 0, f"{what}: K1/K8 {counts}")
    packed_kernel, plain_kernel = _attention_kernels(config)
    check(counts[packed_kernel] == layers * len(packed)
          and counts[plain_kernel] == layers * len(plain)
          and sum(counts[k] for k in ATTENTION) == layers * forwards,
          f"{what}: attention {counts}")
    return forwards


def _attention_kernels(config) -> tuple[str, str]:
    """The counters of the attention a BERT-graph or T5 forward launches on
    packed and on plain rows: K4's forms under a relative position bias."""
    if config.arch in ("mpnet", "t5"):
        return "attn_bse_bias_packed", "attn_bse_bias"
    return "attn_bse_packed", "attn_bse_keybias"


def _counted(counters, fn) -> tuple:
    """fn() with every count set to 0 just before it and read just after."""
    import torch

    reset_counts(counters)
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(counters)


def _forward_inputs(config, seed: int) -> tuple:
    """[32, 512] inputs on the card: ids with every key valid, and packed
    rows of serving-profile segments (ids, seg, pos)."""
    import torch

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    ids = torch.from_numpy(rng.integers(4, config.n_vocab, (32, 512)).astype(np.int32)).to(dev)
    mask = torch.ones(32, 512, dtype=torch.int32, device=dev)
    seg_np, pos_np = serving_segments(rng, 32, 512)
    pids = rng.integers(4, config.n_vocab, (32, 512)).astype(np.int32)
    pids[seg_np < 0] = 0
    return ids, mask, tuple(torch.from_numpy(a).to(dev) for a in (pids, seg_np, pos_np))


def phase_family_main(counters, token_lists, preset, tag: str, seed: int) -> tuple:
    """One BERT-graph or T5 family at its preset's full width and depth
    (Q4_0 weights from seed 0, bf16 activations; the vocab cut to 1000
    synthetic words) over the corpus (T5 frames it anew, without CLS),
    packed (K2, or K4 with MPNet's / T5's relative bias) and plain (K3 or
    K4): launches as the route gives every planned batch, the min cosine of
    256 sentences against the port's f32 CPU path, sentences/s (best of 3)
    and the in-device [32, 512] forward, plain and packed (median of 5).
    Under a relative bias, K4 is then held against its plain version at
    every [B, S] those forwards gave it, with the model's own bias.
    Returns the engine, the launches, the packed forward's arguments and
    the token lists it ran."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import bert_embed_batch, bert_embed_packed

    config = replace(preset, n_vocab=1000, name=f"{preset.name}-synthetic")
    opts = ComputeOptions(dtype="bfloat16")
    t0 = time.perf_counter()
    base = Engine.synthetic(config, "q4_0", seed=0, opts=opts, device="cuda")
    build_s = time.perf_counter() - t0
    if config.arch == "t5":
        token_lists = base.tokenize_batch(synthetic_sentences(len(token_lists), seed=0))
        check(all(t[0] != base.special_ids.cls and t[-1] == base.special_ids.sep
                  for t in token_lists), f"{tag}: T5 framing (ids + </s>, no CLS)")
    engines = {packing: Engine(base.params, config, base.tokenizer, base.special_ids,
                               opts=opts, device="cuda", packing=packing)
               for packing in ("auto", "never")}
    launches, outs, forwards, shapes = {}, {}, {}, []
    for packing, eng in engines.items():
        outs[packing], counts = _counted(counters, lambda e=eng: e.embed_tokens(token_lists))
        packed, plain = _planned_shapes(eng, token_lists)
        shapes += [(True, *sh) for sh in packed] + [(False, *sh) for sh in plain]
        forwards[packing] = _graph_counts_ok(counts, config, packed, plain,
                                              f"{tag} {packing}")
        launches[packing] = counts
        emit({"phase": f"{tag}_launches", "packing": packing, "packed_forwards": len(packed),
              "plain_forwards": len(plain), "launches": counts})
        check(counts[_attention_kernels(config)[packing == "never"]] > 0,
              f"{tag} {packing}: {counts}")
        norms = np.linalg.norm(outs[packing], axis=-1)
        check(np.isfinite(outs[packing]).all()
              and outs[packing].shape == (len(token_lists), config.n_embd)
              and np.abs(norms - 1.0).max() <= 1e-3, f"{tag} {packing}: output")
    best = {p: _best_s(lambda e=eng: e.embed_tokens(token_lists), 3)
            for p, eng in engines.items()}
    ref = Engine(base.params, config, base.tokenizer, base.special_ids,
                 device="cpu").embed_tokens(token_lists[:256])
    cos = {p: _min_cos(outs[p][:256], ref) for p in outs}
    emit({"phase": f"{tag}_vs_cpu", "sentences": 256, "min_cosine": cos,
          "threshold": COSINE_VS_CPU})
    check(min(cos.values()) >= COSINE_VS_CPU, f"{tag} cosine vs CPU {cos}")
    ids, mask, (pids, seg, pos) = _forward_inputs(config, seed)
    with torch.inference_mode():
        plain_ms = gpu_ms(lambda: bert_embed_batch(base.params, ids, mask, config, opts),
                          samples=5, reps=2, spin=500_000_000)
        packed_ms = gpu_ms(lambda: bert_embed_packed(base.params, pids, seg, pos, config,
                                                     opts, n_seg=64),
                           samples=5, reps=2, spin=500_000_000)
    emit({"phase": f"{tag}_main", "model": config.name, "weights": "q4_0",
          "activations": "bfloat16", "params_build_s": build_s,
          "sentences": len(token_lists), "tokens": sum(len(t) for t in token_lists),
          "forwards": forwards,
          "k1_per_forward": (6 + config.ffn_gated) * config.n_layer,
          "attention_per_forward": config.n_layer,
          "sentences_per_sec_packed": len(token_lists) / best["auto"],
          "sentences_per_sec_plain": len(token_lists) / best["never"],
          "forward_ms_in_device_b32_s512": plain_ms,
          "packed_forward_ms_in_device_b32_s512": packed_ms,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if "rel_attn_bias" in base.params:
        phase_kernels_relpos_shapes(base.params["rel_attn_bias"], config, tag,
                                    sorted(set(shapes)) + [(False, 32, 512), (True, 32, 512)])
    total = {name: sum(c[name] for c in launches.values()) for name in counters}
    return base, total, (base.params, config, pids, seg, pos), token_lists


def phase_kernels_relpos_shapes(table, config, tag: str, shapes) -> None:
    """K4 (untimed, bf16 and f32) at every (packed, B, S) a relative-bias
    family's forwards gave it, at the model's heads, with the [H, S, S]
    bias its own table gives (`rel_attn_bias`, T5's far-field cap): plain
    rows with random key padding, packed rows of the serving profile.  The
    short plain buckets (S <= 32) are where a block takes several batch
    rows."""
    import torch

    from embedding_cpp_tpu_torch.models.bert import rel_attn_bias
    from embedding_cpp_tpu_torch.ops.attention import (
        MASK_BIAS,
        attention_bse_plain,
        flash_attention_bias_bse,
        flash_attention_bias_packed_bse,
    )

    dev = torch.device("cuda")
    h, d = config.n_head, config.head_dim
    gen = torch.Generator(device="cpu").manual_seed(13)
    rng = np.random.default_rng(13)
    for packed, b, s in shapes:
        pb = rel_attn_bias(table, s, config.rel_attn_max_dist if config.arch == "t5" else 128)
        if packed:
            mask = torch.from_numpy(serving_segments(rng, b, s)[0]).to(dev)
        else:
            lens = torch.from_numpy(rng.integers(1, s + 1, size=b))
            mask = torch.where(torch.arange(s)[None, :] < lens[:, None], 0.0,
                               MASK_BIAS).to(torch.float32).to(dev)
        fn = flash_attention_bias_packed_bse if packed else flash_attention_bias_bse
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(b, s, h * d, generator=gen).to(dev, dtype) for _ in range(3))
            _attention_case(
                "attn_bse_bias_packed" if packed else "attn_bse_bias",
                lambda *a, fn=fn: fn(*a, h),
                lambda *a, sm=packed: attention_bse_plain(a[0], a[1], a[2], a[3], h, sm, a[4]),
                None, (q, k, v, mask, pb), 0.0, 0.0, None, False,
                model=tag, b=b, s=s, h=h, d=d, bias_heads=h)
            del q, k, v
    torch.cuda.empty_cache()


def _score_counted(counters, eng, pair_ids, pair_types, what: str) -> tuple:
    """One score_token_pairs call over the pairs' length buckets, counted:
    K1 and K3 as the route gives every batch."""
    shapes = [tuple(b.ids.shape) for b in eng.score_plan(pair_ids)]
    logits, counts = _counted(counters, lambda: eng.score_token_pairs(pair_ids, pair_types))
    _graph_counts_ok(counts, eng.config, [], shapes, what)
    check(logits.shape == (len(pair_ids),) and np.isfinite(logits).all(), f"{what} logits")
    return logits, counts, shapes


def phase_family_pairs(counters, config, tag: str, label: str) -> tuple:
    """A one-logit cross-encoder of the family's geometry (Q4_0 weights from
    seed 1, bf16): XLM-R and MPNet with RoBERTa's tanh ClassificationHead,
    pairs framed <s> q </s></s> p </s> with one segment; ALBERT with its
    pooler + classifier, [CLS] q [SEP] p [SEP] with segments 0/1.  64
    query/passage pairs, untimed, through score_token_pairs (K3, or K4
    under MPNet's relative bias), held to the cross-encoder logit bars."""
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions

    rr_config = replace(config, n_labels=1, name=f"{label}-synthetic")
    rr = Engine.synthetic(rr_config, "q4_0", seed=1, opts=ComputeOptions(dtype="bfloat16"),
                          device="cuda")
    pair_ids, pair_types = rr.tokenize_pairs(_rerank_pairs(64, seed=11))
    sep = rr.special_ids.sep
    double = [any(t[i] == t[i + 1] == sep for i in range(len(t) - 1)) for t in pair_ids]
    if config.arch in ("roberta", "mpnet"):
        check(all(double) and not any(map(any, pair_types)),
              f"{tag} pairs: the double-separator framing")
    else:
        check(not any(double) and all(1 in t for t in pair_types), f"{tag} pairs: two segments")
    logits, counts, shapes = _score_counted(counters, rr, pair_ids, pair_types, f"{tag} score")
    vs = _logits_vs_cpu(rr, pair_ids, pair_types, logits, tag, spread_scaled=True)
    emit({"phase": f"{tag}_pairs", "model": rr_config.name, "head": rr_config.head_activation,
          "batch_shapes": shapes, "launches": counts, **vs})
    return rr, counts


def phase_t5_gated(counters) -> dict:
    """A gated-GELU T5 at t5-v1.1-base's width (768, 12 layers, 12 heads of
    64, FFN 2048, act(wi_0 x) * wi_1 x with gelu_tanh; Q4_0 from seed 0,
    bf16): 64 corpus sentences framed without CLS, untimed, through K1 (the
    wi_1 product in the down projection's prologue) and K4, against the
    port's f32 CPU path, with the CPU's bf16 path's distance beside it."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import GTR_BASE, ComputeOptions

    config = replace(GTR_BASE, n_vocab=1000, n_ff=2048, ffn_act="gelu_tanh", ffn_gated=True,
                     name="t5-v1.1-base-synthetic")
    eng = Engine.synthetic(config, "q4_0", seed=0, opts=ComputeOptions(dtype="bfloat16"),
                           device="cuda")
    few = eng.tokenize_batch(synthetic_sentences(64, seed=5))
    out, counts = _counted(counters, lambda: eng.embed_tokens(few))
    packed, plain = _planned_shapes(eng, few)
    _graph_counts_ok(counts, config, packed, plain, "t5 gated")
    check(counts["q4_matmul_prologue"] == config.n_layer * (len(packed) + len(plain)) > 0,
          f"t5 gated: prologue {counts}")
    cpu = {dtype: Engine(eng.params, config, eng.tokenizer, eng.special_ids,
                         opts=ComputeOptions(dtype=dtype), device="cpu").embed_tokens(few)
           for dtype in ("float32", "bfloat16")}
    cos = _min_cos(out, cpu["float32"])
    # the CPU's own bf16 path beside it: how far bf16 alone takes this
    # random-weight gated FFN from f32
    emit({"phase": "t5_gated", "model": config.name, "sentences": len(few),
          "packed_forwards": len(packed), "plain_forwards": len(plain), "launches": counts,
          "min_cosine": cos, "threshold": COSINE_VS_CPU,
          "cpu_bf16_min_cosine": _min_cos(cpu["bfloat16"], cpu["float32"])})
    check(cos >= COSINE_VS_CPU, f"t5 gated cosine vs CPU {cos}")
    torch.cuda.empty_cache()
    return counts


def phase_electra(counters, token_lists) -> tuple:
    """ms-marco-electra-base (Q4_0 weights from seed 0, bf16; the vocab cut
    to 1000): 256 MS MARCO-profile pairs framed [CLS] q [SEP] p [SEP]
    (segments 0/1) through score_token_pairs on K3, pairs/s (best of 3),
    the logit bars on 64 of them; then ELECTRA-small untimed: 128-wide
    tables projected to 256 by the dense `emb_proj` (torch.matmul), 64
    corpus sentences against the port's f32 CPU path."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import (
        ELECTRA_SMALL,
        MS_MARCO_ELECTRA_BASE,
        ComputeOptions,
    )

    opts = ComputeOptions(dtype="bfloat16")
    config = replace(MS_MARCO_ELECTRA_BASE, n_vocab=1000,
                     name="ms-marco-electra-base-synthetic")
    base = Engine.synthetic(config, "q4_0", seed=0, opts=opts, device="cuda")
    pairs = _rerank_pairs(256, seed=8)
    pair_ids, pair_types = base.tokenize_pairs(pairs)
    check(all(1 in t for t in pair_types), "electra pairs: two segments")
    logits, counts, shapes = _score_counted(counters, base, pair_ids, pair_types,
                                            "electra score")
    best = _best_s(lambda: base.score_token_pairs(pair_ids, pair_types), 3)
    vs = _logits_vs_cpu(base, pair_ids, pair_types, logits, "electra", spread_scaled=True)

    small_config = replace(ELECTRA_SMALL, n_vocab=1000, name="electra-small-synthetic")
    small = Engine.synthetic(small_config, "q4_0", seed=0, opts=opts, device="cuda")
    proj = small.params["embeddings"]["emb_proj_w"]
    check(tuple(proj.shape) == (128, 256) and proj.dtype == torch.bfloat16,
          f"electra-small emb_proj {tuple(proj.shape)} {proj.dtype}")
    few = token_lists[:64]
    out, small_counts = _counted(counters, lambda: small.embed_tokens(few))
    packed, plain = _planned_shapes(small, few)
    _graph_counts_ok(small_counts, small_config, packed, plain, "electra-small")
    ref = Engine(small.params, small_config, small.tokenizer, small.special_ids,
                 device="cpu").embed_tokens(few)
    small_cos = _min_cos(out, ref)
    emit({"phase": "electra", "model": config.name, "weights": "q4_0",
          "activations": "bfloat16", "pairs": len(pairs),
          "pair_tokens": sum(len(t) for t in pair_ids), "batch_shapes": shapes,
          "launches": counts, "pairs_per_sec": len(pairs) / best, "logits_vs_cpu": vs,
          "small": {"model": small_config.name, "sentences": len(few),
                    "packed_forwards": len(packed), "plain_forwards": len(plain),
                    "launches": small_counts, "min_cosine": small_cos,
                    "threshold": COSINE_VS_CPU}})
    check(small_cos >= COSINE_VS_CPU, f"electra-small cosine vs CPU {small_cos}")
    torch.cuda.empty_cache()
    return counts, small_counts


def _profiled(fn):
    """Run `fn` under torch.profiler; returns (wall ms inside the profiled
    region, kernel rows [(name, device us, calls)] by device time, table)."""
    import torch
    from torch.autograd import DeviceType

    with trace() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    if not len(averages):  # nothing ran on this thread, nor on the card
        return wall_ms, [], ""
    attr = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
            else "self_cuda_time_total")  # the name differs by torch version
    # kernel rows only: the aten:: rows repeat their kernels' time
    rows = sorted(((ev.key, getattr(ev, attr), ev.count) for ev in averages
                   if ev.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    return wall_ms, rows, averages.table(sort_by=attr, row_limit=40)


def phase_profile(forward_args, engine, token_lists, out_dir, tag: str = "") -> None:
    import torch

    from embedding_cpp_tpu_torch.models import ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import bert_embed_packed

    params, config, ids, seg, pos = forward_args
    opts = ComputeOptions(dtype="bfloat16")
    with torch.inference_mode():
        _, rows, table = _profiled(
            lambda: bert_embed_packed(params, ids, seg, pos, config, opts, n_seg=64))
    _save(out_dir, f"profile_{tag}packed_forward.txt", table)
    emit({"phase": "profile", "model": config.name, "what": "packed forward [32, 512]",
          "device_busy_ms": sum(r[1] for r in rows) / 1e3,
          "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n}
                  for k, us, n in rows[:10]]})
    # the whole serving call: device busy time against wall time
    wall_ms, rows, table = _profiled(lambda: engine.embed_tokens(token_lists))
    _save(out_dir, f"profile_{tag}embed_tokens.txt", table)
    busy_ms = sum(r[1] for r in rows) / 1e3
    emit({"phase": "profile", "model": config.name,
          "what": "embed_tokens, 2758 sentences, packed",
          "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms)})


def _recv(s, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        check(bool(chunk), "server closed the connection")
        buf += chunk
    return buf


def _http(port: int, method: str, path: str, payload=None, conn=None) -> tuple[int, bytes]:
    """One HTTP request (on `conn`, kept alive, when given) -> (status, body)."""
    import http.client

    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path, None if payload is None else json.dumps(payload).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        if own:
            conn.close()


def _b64_vectors(body: dict) -> np.ndarray:
    import base64

    return np.stack([np.frombuffer(base64.b64decode(d["embedding"]), np.float32)
                     for d in body["data"]])


def phase_server(engine) -> None:
    texts = ["hello world", "the quick brown fox jumps over the lazy dog",
             "welcome back soon"]
    want = engine.encode(texts)
    with _serving(engine) as port, socket.create_connection(("127.0.0.1", port), 10) as s:
        s.settimeout(60)
        (n_embd,) = struct.unpack("<i", _recv(s, 4))
        check(n_embd == engine.n_embd, f"handshake n_embd {n_embd}")
        s.sendall(texts[1].encode())
        raw = np.frombuffer(_recv(s, 4 * n_embd), np.float32)
        body = b"".join(struct.pack("<I", len(t.encode())) + t.encode() for t in texts)
        s.sendall(b"TPE2" + struct.pack("<I", len(texts)) + body)
        (count,) = struct.unpack("<I", _recv(s, 4))
        check(count == len(texts), f"TPE2 count {count}")
        vecs = np.frombuffer(_recv(s, 4 * count * n_embd), np.float32).reshape(count, -1)
    cos_raw = float(np.dot(raw, want[1]) / np.linalg.norm(raw) / np.linalg.norm(want[1]))
    cos_tpe2 = float(np.min(np.sum(vecs * want, -1) / np.linalg.norm(vecs, axis=-1)
                            / np.linalg.norm(want, axis=-1)))
    emit({"phase": "server", "model": engine.config.name, "n_embd": n_embd,
          "raw_cosine": cos_raw,
          "tpe2_min_cosine": cos_tpe2, "threshold": COSINE_SERVER})
    check(min(cos_raw, cos_tpe2) >= COSINE_SERVER, "server replies differ from encode")


def phase_server_frames(engine) -> None:
    """The reference's bert.h frames on one connection to the server over
    the GPU engine: health, stats, meta, tokenize (== Engine.tokenize),
    eval of those ids (== Engine.embed_tokens), vocab (== id_to_token; an
    unknown id gives an empty token), int8 encode (against encode), a
    search frame before any index frame: its error frame, then a TPE2
    frame on the same socket answered; and eval frames with an id past the
    vocab and a negative id: each gets the error frame before anything
    launches, and a valid eval frame behind them is answered (the CUDA
    context survives)."""
    texts = ["hello world", "the quick brown fox jumps over the lazy dog", "welcome back soon"]
    ids = [engine.tokenize(t) for t in texts]
    want_eval, want_enc = engine.embed_tokens(ids), engine.encode(texts)
    body = struct.pack("<I", len(texts)) + b"".join(
        struct.pack("<I", len(t.encode())) + t.encode() for t in texts)
    n_embd = engine.n_embd

    def u32(s) -> int:
        (v,) = struct.unpack("<I", _recv(s, 4))
        if v == 0xFFFFFFFF:
            raise RuntimeError(f"error frame: {_recv(s, struct.unpack('<I', _recv(s, 4))[0])}")
        return v

    def f32_rows(s) -> np.ndarray:
        n = u32(s)
        return np.frombuffer(_recv(s, 4 * n * n_embd), np.float32).reshape(n, n_embd)

    def eval_frame(lists) -> bytes:
        return b"\x01TPI" + struct.pack("<I", len(lists)) + b"".join(
            struct.pack("<I", len(t)) + np.asarray(t, np.int32).tobytes() for t in lists)

    with _serving(engine) as port, socket.create_connection(("127.0.0.1", port), 10) as s:
        s.settimeout(60)
        _recv(s, 4)
        s.sendall(b"TPEH")
        health = _recv(s, 6)
        s.sendall(b"TPES")
        stats = json.loads(_recv(s, u32(s)))
        s.sendall(b"\x01TPM")
        meta = json.loads(_recv(s, u32(s)))
        s.sendall(b"\x01TPT" + body)
        toks = []
        for _ in range(u32(s)):
            toks.append(np.frombuffer(_recv(s, 4 * u32(s)), np.int32).tolist())
        s.sendall(eval_frame(ids))
        got_eval = f32_rows(s)
        vocab = []
        for i in ids[1] + [engine.config.n_vocab + 5]:
            s.sendall(b"\x01TPV" + struct.pack("<I", i))
            vocab.append(_recv(s, u32(s)).decode())
        s.sendall(b"\x01TP8" + body)
        n = u32(s)
        scale = np.frombuffer(_recv(s, 4 * n), np.float32)
        codes = np.frombuffer(_recv(s, n * n_embd), np.int8).reshape(n, n_embd)
        s.sendall(b"\x01TPS" + struct.pack("<I", 3) + body + b"TPE2" + body)  # no index yet
        (flag,) = struct.unpack("<I", _recv(s, 4))
        error = _recv(s, struct.unpack("<I", _recv(s, 4))[0]).decode()
        after = f32_rows(s)
        bad_replies = []
        for bad in (engine.config.n_vocab, -1):
            s.sendall(eval_frame([ids[0], [ids[1][0], bad, ids[1][-1]]]))
            (bad_flag,) = struct.unpack("<I", _recv(s, 4))
            bad_replies.append((bad_flag, _recv(s, struct.unpack("<I", _recv(s, 4))[0]).decode()))
        s.sendall(eval_frame(ids))
        after_bad = f32_rows(s)
    cos_eval, cos_i8 = _min_cos(got_eval, want_eval), _min_cos(codes * scale[:, None], want_enc)
    cos_after, cos_after_bad = _min_cos(after, want_enc), _min_cos(after_bad, want_eval)
    emit({"phase": "server_frames", "model": engine.config.name, "health": health[4:].decode(),
          "stats_server": stats.get("server"), "meta": meta, "tokens": toks[1][:8],
          "eval_min_cosine": cos_eval, "int8_min_cosine": cos_i8, "search_reply": error,
          "after_error_min_cosine": cos_after, "out_of_vocab_replies": bad_replies,
          "after_out_of_vocab_min_cosine": cos_after_bad})
    check(health == struct.pack("<I", 2) + b"ok", f"health {health!r}")
    check(stats["server"]["connections"] >= 1 and "counters" in stats, f"stats {stats}")
    check(meta == {"n_embd": n_embd, "n_max_tokens": engine.n_max_tokens,
                   "name": engine.config.name}, f"meta {meta}")
    check(toks == ids, "tokenize frame differs from Engine.tokenize")
    check(vocab == [engine.id_to_token(i) for i in ids[1]] + [""], f"vocab {vocab}")
    check(min(cos_eval, cos_after) >= COSINE_SERVER, "eval/TPE2 replies differ from the engine")
    check(cos_i8 >= COSINE_INT8, f"int8 reply cosine {cos_i8}")
    check(flag == 0xFFFFFFFF and error.startswith("RuntimeError: no index built"),
          f"search frame before any index: {flag:#x} {error!r}")
    check(all(f == 0xFFFFFFFF and "outside 0.." in e for f, e in bad_replies),
          f"out-of-vocab eval replies {bad_replies}")
    check(cos_after_bad >= COSINE_SERVER, "eval after the out-of-vocab frames differs")


def phase_rerank_server(engine) -> None:
    """One rerank frame to the server over the GPU DeBERTa cross-encoder:
    the ranking equals Engine.rerank's."""
    from embedding_cpp_tpu_torch.runtime.server import MAGIC_RERANK

    query, docs = _rerank_pairs(1, seed=9)[0][0], [p for _, p in _rerank_pairs(8, seed=10)]
    top_n = 5
    want = engine.rerank(query, docs, top_n=top_n)
    body = b"".join(struct.pack("<I", len(d.encode())) + d.encode() for d in docs)
    with _serving(engine) as port, socket.create_connection(("127.0.0.1", port), 10) as s:
        s.settimeout(60)
        _recv(s, 4)
        s.sendall(MAGIC_RERANK + struct.pack("<II", top_n, len(query.encode()))
                  + query.encode() + struct.pack("<I", len(docs)) + body)
        (m,) = struct.unpack("<I", _recv(s, 4))
        check(m == top_n, f"rerank reply count {m}")
        idx = np.frombuffer(_recv(s, 4 * m), np.int32).tolist()
        scores = np.frombuffer(_recv(s, 4 * m), np.float32)
    err = float(np.abs(scores - [r["relevance_score"] for r in want]).max())
    emit({"phase": "rerank_server", "documents": len(docs), "top_n": top_n, "indices": idx,
          "max_abs_score_err": err})
    check(idx == [r["index"] for r in want] and err <= 1e-6,
          f"rerank frame {idx} differs from Engine.rerank {want}")


def phase_kernels_seg_local(peaks) -> dict:
    """Mode 3 (segments and the sliding window 128; ModernBERT's local
    layers on packed rows past 1024) against its plain version, bf16 and
    f32: at the chunk-row shape [8, 2048, 12x64] with the segments of the
    512-chunk plan (bf16 timed), at S = 1032 (no slice: every key), at
    [2, 8192] with four packed documents a row, and at [2, 2048] with
    segments shorter and longer than the window and a row all padding.
    The library call is SDPA with the materialised boolean [B, 1, S, S]
    mask seg_q == seg_k & |q - k| <= 64.  Bound: 4*H*d operations for each
    (query, key) pair that shares a segment and lies within the window,
    padding included (`segment_window_pairs`)."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.benchmarks.profiles import segment_window_pairs
    from embedding_cpp_tpu_torch.ops.attention import (
        attention_packed_local_plain,
        flash_attention_packed_local,
        local_window_tiles,
    )
    from embedding_cpp_tpu_torch.runtime.batching import pack_segments
    from embedding_cpp_tpu_torch.tokenizer import SpecialIds

    dev = torch.device("cuda")
    h, d, window = 12, 64, 128
    gen = torch.Generator(device="cpu").manual_seed(15)
    rng = np.random.default_rng(15)

    def run(seg_np, dtype, timed, segments):
        b, s = seg_np.shape
        seg = torch.from_numpy(seg_np).to(dev)
        q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dev, dtype) for _ in range(3))
        heads = allowed = None
        if timed:
            heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
            pos = torch.arange(s, device=dev)
            inwin = (pos[None, :] - pos[:, None]).abs() <= window // 2
            allowed = ((seg[:, :, None] == seg[:, None, :]) & inwin)[:, None]
        tq, wmax = local_window_tiles(s, window)
        pairs = segment_window_pairs(seg_np, window)
        nbytes = 4 * q.numel() * q.element_size() + seg.numel() * 4
        return _attention_case(
            "attn_seg_local", lambda *a: flash_attention_packed_local(*a, window),
            lambda *a: attention_packed_local_plain(*a, window),
            lambda: F.scaled_dot_product_attention(*heads, attn_mask=allowed), (q, k, v, seg),
            nbytes, 4.0 * h * pairs * d, peaks, timed, b=b, s=s, h=h, d=d, window=window,
            tq=tq, wmax=wmax or s, segments=segments,
            pair_share=pairs / (b * s * (wmax or s)))

    chunks = _chunks(512, 128, 512, seed=0, special=SpecialIds(cls=2, sep=3, pad=0, unk=1))
    plan = pack_segments(chunks, list(range(len(chunks))), 0, seq_len=2048, n_seg=256)
    chunk_rows = plan[0].seg[:8]
    mixed = np.full((2, 2048), -1, np.int32)
    c = g = 0
    for n in (20, 300, 40, 700, 3, 128, 65, 500):  # shorter and longer than the window
        mixed[0, c:c + n] = g
        c, g = c + n, g + 1
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        timed = dtype == torch.bfloat16
        c = run(chunk_rows, dtype, timed, "the 512-chunk plan's first 8 rows (128-512 tokens)")
        if timed:
            results["attn_seg_local"] = c
        run(packed_rows(rng, 3, 1032, 40, 300)[0], dtype, False, [40, 300])
        run(packed_rows(rng, 2, 8192, 1900, 2040)[0], dtype, False, "4 documents a row")
        run(mixed, dtype, False, "20-700 tokens, then a row all padding")
        torch.cuda.empty_cache()
    return results


def _attention_at(peaks, kernel: str, b: int, s: int, lens, window: int | None,
                  long: bool, model: str = "gte-reranker-modernbert-base") -> dict:
    """One timed bf16 check of a path's attention at its own shape [b, s,
    12x64] with key padding to `lens`: the projection layout (K3, or K4 with
    ModernBERT's [1, S, S] window bias) or the long-row kernel (K5, or K7
    over its slices), beside SDPA with the same additive mask."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.models.modernbert import window_bias
    from embedding_cpp_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    h, d = 12, 64
    gen = torch.Generator(device="cpu").manual_seed(b * s)
    keyb = torch.where(torch.arange(s)[None, :] < torch.as_tensor(lens)[:, None], 0.0,
                       A.MASK_BIAS).to(torch.float32).to(dev)
    q, k, v = (torch.randn(b, s, h, d, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    wb = None if window is None else window_bias(s, window, dev)
    lmask = keyb[:, None, None, :] + (0.0 if wb is None else wb[None])
    pos = torch.arange(s)
    pairs = (float(b * s * s) if window is None else b * float(
        (torch.clamp(pos + window // 2, max=s - 1) - torch.clamp(pos - window // 2, min=0)
         + 1).sum()))
    nbytes = 4 * q.numel() * 2 + b * s * 4
    if long:
        fn = ((lambda *a: A.flash_attention_local(*a, window)) if window
              else A.flash_attention)
        plain = ((lambda *a: A.attention_local_plain(*a, window)) if window
                 else A.attention_long_plain)
        args = (q, k, v, keyb)
    else:
        e = h * d
        fn = lambda *a: A.flash_attention_bse(a[0].reshape(b, s, e), a[1].reshape(b, s, e),
                                              a[2].reshape(b, s, e), a[3], h, wb)
        plain = lambda *a: A.attention_bse_plain(a[0].reshape(b, s, e), a[1].reshape(b, s, e),
                                                 a[2].reshape(b, s, e), a[3], h, False, wb)
        args = (q, k, v, keyb)
        if wb is not None:
            nbytes += wb.numel() * 4
    return _attention_case(kernel, fn, plain,
                           lambda: F.scaled_dot_product_attention(
                               *heads, attn_mask=lmask.to(torch.bfloat16)),
                           args, nbytes, 4.0 * h * pairs * d, peaks, True, b=b, s=s, h=h, d=d,
                           window=window, model=model)


def _modernbert_packed_counts_ok(counts: dict, forwards: int, glob: str, what: str) -> None:
    """Per forward on packed rows past 1024: 154 K1 launches (22 with the
    prologue), 8 global layers on K6 (`glob`: windowed or every key), 14
    local layers on mode 3."""
    check(counts["q4_matmul"] == 154 * forwards and counts["q4_matmul_2d"] == 0
          and counts["q4_matmul_prologue"] == 22 * forwards, f"{what}: K1 {counts}")
    check(counts[glob] == 8 * forwards and counts["attn_seg_local"] == 14 * forwards
          and sum(counts[k] for k in ATTENTION) == 22 * forwards, f"{what}: attention {counts}")


def phase_modernbert_chunks(counters, base, out_dir) -> dict:
    """ModernBERT-base (Q4_0, bf16) at Engine(pack_seq=2048): 512 RAG chunks
    of 128-512 tokens (seed 0) in rows of 2048 with the bound 512 (global
    layers on the windowed K6, local layers on mode 3): chunks/s, best of
    3, the in-device [8, 2048] forward and its torch.profiler breakdown; 32
    documents of 600-1400 tokens packed "always" (K6 over every key); min
    cosine against the port's f32 CPU path on 16 chunks and 2 documents."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models.bert import bert_embed_packed
    from embedding_cpp_tpu_torch.runtime.engine import segment_bound

    def engine(card: bool, **kw):
        """On the card in the phase's bf16, or the f32 CPU reference."""
        return Engine(base.params, base.config, base.tokenizer, base.special_ids,
                      opts=base.opts if card else None, device="cuda" if card else "cpu",
                      pack_seq=2048, **kw)

    eng, docs_eng = engine(True), engine(True, packing="always")
    chunks = _chunks(512, 128, 512, seed=0, special=base.special_ids)
    plan = _packed_plan(eng, chunks)
    check(sum(len(pb.orig) for pb in plan) == len(chunks)
          and {segment_bound(pb) for pb in plan} == {512}, "modernbert chunk plan")
    out, counts = _counted(counters, lambda: eng.embed_tokens(chunks))
    emit({"phase": "modernbert_chunks_launches", "forwards": len(plan), "launches": counts})
    _modernbert_packed_counts_ok(counts, len(plan), "attn_seg_window", "modernbert chunks")
    norms = np.linalg.norm(out, axis=-1)
    check(np.isfinite(out).all() and np.abs(norms - 1.0).max() <= 1e-3, "chunks: output")
    best = _best_s(lambda: eng.embed_tokens(chunks), 3)

    docs = _chunks(32, 600, 1400, seed=1, special=base.special_ids)
    doc_plan = _packed_plan(docs_eng, docs)
    check(sum(len(pb.orig) for pb in doc_plan) == len(docs)
          and {segment_bound(pb) for pb in doc_plan} == {2048}, "modernbert document plan")
    _, doc_counts = _counted(counters, lambda: docs_eng.embed_tokens(docs))
    _modernbert_packed_counts_ok(doc_counts, len(doc_plan), "attn_seg", "modernbert documents")
    best_docs = _best_s(lambda: docs_eng.embed_tokens(docs), 3)

    pb = plan[0]
    dev = torch.device("cuda")
    ids, seg, pos = (torch.from_numpy(a[:8]).to(dev) for a in (pb.ids, pb.seg, pb.pos))

    def forward():
        return bert_embed_packed(base.params, ids, seg, pos, base.config, base.opts,
                                 n_seg=eng.pack_segs, max_seg_len=512)

    with torch.inference_mode():
        fwd_ms = gpu_ms(forward, samples=5, reps=2, spin=500_000_000)
        _, rows, table = _profiled(forward)
    _save(out_dir, "profile_modernbert_chunk_forward_b8_s2048.txt", table)
    busy = sum(r[1] for r in rows) / 1e3
    emit({"phase": "profile", "model": base.config.name, "what": "packed forward [8, 2048]",
          "device_busy_ms": busy,
          "top": [{"name": k[:80], "device_ms": us / 1e3, "calls": n, "share": us / 1e3 / busy}
                  for k, us, n in rows[:10]]})
    wall_ms, rows, table = _profiled(lambda: eng.embed_tokens(chunks))
    _save(out_dir, "profile_modernbert_chunks_embed_tokens.txt", table)
    busy_ms = sum(r[1] for r in rows) / 1e3
    emit({"phase": "profile", "model": base.config.name,
          "what": "embed_tokens, 512 chunks, pack_seq 2048",
          "wall_ms_under_profiler": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms)})

    # fewer than 32 chunks pack only with packing "always"
    few, two = chunks[:16], docs[:2]
    got, few_counts = _counted(counters, lambda: docs_eng.embed_tokens(few))
    got_docs, two_counts = _counted(counters, lambda: docs_eng.embed_tokens(two))
    check(few_counts["attn_seg_local"] > 0 and two_counts["attn_seg_local"] > 0,
          f"vs cpu: {few_counts} {two_counts}")
    cpu = engine(False, packing="always")
    cos = {"chunks_packed_2048": _min_cos(got, cpu.embed_tokens(few)),
           "documents_packed_2048": _min_cos(got_docs, cpu.embed_tokens(two))}
    tokens = sum(len(t) for t in chunks)
    slots = sum(p.ids.size for p in plan)
    emit({"phase": "modernbert_chunks", "model": base.config.name, "chunks": len(chunks),
          "tokens": tokens, "pack_seq": 2048, "batch_shapes": [list(p.ids.shape) for p in plan],
          "token_slots": slots, "padded_token_slots": slots - tokens, "max_seg_len": 512,
          "chunks_per_sec": len(chunks) / best,
          "packed_forward_ms_in_device_b8_s2048": fwd_ms,
          "documents": len(docs), "document_tokens": sum(len(t) for t in docs),
          "document_batch_shapes": [list(p.ids.shape) for p in doc_plan],
          "documents_per_sec": len(docs) / best_docs,
          "min_cosine_vs_cpu": cos, "threshold": COSINE_VS_CPU,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    check(min(cos.values()) >= COSINE_VS_CPU, f"modernbert chunks cosine vs CPU {cos}")
    return {k: counts[k] + doc_counts[k] + few_counts[k] + two_counts[k] for k in counts}


def _long_pairs(n: int, lo: int, hi: int, seed: int, special) -> tuple[list, list]:
    """n framed pairs [CLS] a [SEP] b [SEP] of lo..hi tokens (a query of 12
    tokens), with their type ids."""
    rng = np.random.default_rng(seed)
    ids, types = [], []
    for m in rng.integers(lo, hi + 1, n):
        a = rng.integers(4, 1000, 12).tolist()
        b = rng.integers(4, 1000, int(m) - 15).tolist()
        ids.append([special.cls] + a + [special.sep] + b + [special.sep])
        types.append([0] * 14 + [1] * (len(b) + 1))
    return ids, types


def phase_modernbert_rerank(counters, peaks) -> tuple:
    """gte-reranker-modernbert-base's geometry (ModernBERT-base, one logit
    through the PredictionHead, mean pooling; Q4_0 from seed 1, bf16): 256
    MS MARCO-profile pairs through score_token_pairs (K3 on global layers,
    K4 with the window bias on local ones): pairs/s, best of 5; 64 pairs'
    logits against the CPU path at DeBERTa's bars scaled to the logits'
    spread; 4 pairs of 2048-4096 tokens (K5 and K7), their f32 logits
    against the CPU's by Pearson; each attention kernel timed at the
    path's own shapes."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import MODERNBERT_BASE, ComputeOptions

    config = replace(MODERNBERT_BASE, n_vocab=1000, n_labels=1, head_activation="gelu",
                     pooling="mean", name="gte-reranker-modernbert-base-synthetic")
    rr = Engine.synthetic(config, "q4_0", seed=1, opts=ComputeOptions(dtype="bfloat16"),
                          device="cuda")
    pair_ids, pair_types = rr.tokenize_pairs(_rerank_pairs(256, seed=8))
    sp = rr.special_ids
    check(all(t[0] == sp.cls and t[-1] == sp.sep and t.count(sp.sep) == 2 for t in pair_ids),
          "modernbert pairs: [CLS] a [SEP] b [SEP]")
    plan = rr.score_plan(pair_ids)
    shapes = [list(b.ids.shape) for b in plan]
    logits, counts = _counted(counters, lambda: rr.score_token_pairs(pair_ids, pair_types))
    f = len(plan)
    check(counts["q4_matmul"] == 154 * f and counts["q4_matmul_prologue"] == 22 * f
          and counts["attn_bse_keybias"] == 8 * f and counts["attn_bse_bias"] == 14 * f
          and sum(counts[k] for k in ATTENTION) == 22 * f, f"modernbert score {counts}")
    check(logits.shape == (256,) and np.isfinite(logits).all(), "modernbert logits")
    best = _best_s(lambda: rr.score_token_pairs(pair_ids, pair_types), 5)
    vs = _logits_vs_cpu(rr, pair_ids, pair_types, logits, "modernbert rerank",
                        spread_scaled=True)

    long_ids, long_types = _long_pairs(4, 2048, 4096, seed=12, special=sp)
    long_plan = rr.score_plan(long_ids)
    long_logits, long_counts = _counted(counters,
                                        lambda: rr.score_token_pairs(long_ids, long_types))
    fl = len(long_plan)
    check(long_counts["q4_matmul"] == 154 * fl and long_counts["attn_long"] == 8 * fl
          and long_counts["attn_local"] == 14 * fl
          and sum(long_counts[k] for k in ATTENTION) == 22 * fl, f"long pairs {long_counts}")
    f32 = Engine(rr.params, config, rr.tokenizer, sp, device="cuda")
    cpu = Engine(rr.params, config, rr.tokenizer, sp, device="cpu")
    got_f32 = f32.score_token_pairs(long_ids, long_types)
    ref_f32 = cpu.score_token_pairs(long_ids, long_types)
    long_vs = {"pairs": len(long_ids), "tokens": [len(t) for t in long_ids],
               "batch_shapes": [list(b.ids.shape) for b in long_plan],
               "f32_pearson": _pearson(got_f32, ref_f32),
               "f32_max_abs_logit_err": float(np.abs(got_f32 - ref_f32).max()),
               "bf16_pearson": _pearson(long_logits, ref_f32), "threshold": PEARSON_F32}
    check(long_vs["f32_pearson"] >= PEARSON_F32 and np.isfinite(long_logits).all(),
          f"long pairs {long_vs}")

    big = max(plan, key=lambda b: b.ids.size)
    lens = big.mask.sum(1)
    b, s = big.ids.shape
    timed = {"attn_bse_keybias": _attention_at(peaks, "attn_bse_keybias", b, s, lens, None,
                                               False),
             "attn_bse_bias": _attention_at(peaks, "attn_bse_bias", b, s, lens, 128, False)}
    lb = max(long_plan, key=lambda b: b.ids.size)
    b, s = lb.ids.shape
    timed["attn_long"] = _attention_at(peaks, "attn_long", b, s, lb.mask.sum(1), None, True)
    timed["attn_local"] = _attention_at(peaks, "attn_local", b, s, lb.mask.sum(1), 128, True)
    emit({"phase": "modernbert_rerank", "model": config.name, "pooling": config.pooling,
          "pairs": len(pair_ids), "pair_tokens": sum(len(t) for t in pair_ids),
          "batch_shapes": shapes, "pairs_per_sec": len(pair_ids) / best, "launches": counts,
          "long_pairs": long_vs, "long_launches": long_counts, "vs_cpu": vs,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    phase_rerank_server(rr)
    total = {k: counts[k] + long_counts[k] for k in counts}
    return total, timed


def _sparse_vec(pairs, n_vocab: int) -> np.ndarray:
    """(ids, weights) per text -> dense [n, n_vocab] f32."""
    out = np.zeros((len(pairs), n_vocab), np.float32)
    for i, (idx, val) in enumerate(pairs):
        out[i, idx] = val
    return out


def phase_splade(counters, peaks, texts) -> tuple:
    """SPLADE at BERT-base geometry (768 wide, 12 layers, 12 heads of 64,
    FFN 3072) with the MLM head, n_vocab 30522 kept (the decoder's N is the
    vocabulary), Q4_0 from seed 0, bf16: the STSB-profile corpus through
    sparse_tokens(k=256): sentences/s, best of 3; the encoder's K1/K3 and
    the decoder's K1/K8 launches as `route` gives every planned batch; the
    decoder shape against its plain version and addmm on the dequantized
    weight (K8 forced beside it); 64 sentences against the port's CPU
    path: the card's f32 path gives the same id sets with weights within
    1e-4, the bf16 path cosine >= 0.995 of the rebuilt 30522-wide vectors
    (every positive term) against the CPU's f32 path and >= 0.999 against
    its bf16 path."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import BertConfig, ComputeOptions
    from embedding_cpp_tpu_torch.models.bert import sparse_chunk
    from embedding_cpp_tpu_torch.ops.q4_matmul import (
        _q4_matmul_2d,
        dequant_weight,
        q4_matmul,
        q4_matmul_plain,
        route,
    )
    from embedding_cpp_tpu_torch.runtime.batching import pack_batches

    config = BertConfig(n_vocab=30522, n_ctx=512, n_embd=768, n_layer=12, n_head=12,
                        n_ff=3072, mlm_head=True, name="splade-bert-base-synthetic")
    opts = ComputeOptions(dtype="bfloat16")
    sp = Engine.synthetic(config, "q4_0", seed=0, opts=opts, device="cuda")
    lists = sp.tokenize_batch(texts)
    budget = sp._sparse_budget()
    row_cap = max(1, budget // (8 * config.n_vocab * 4))
    plan = pack_batches(lists, sp.special_ids.pad, seq_buckets=sp.seq_buckets,
                        batch_buckets=tuple(b for b in sp.batch_buckets if b <= row_cap),
                        max_seq=config.n_ctx, max_tokens=sp.max_batch_tokens, pad_rows=False)
    w = sp.params["mlm"]["decoder_w"]
    dec, dec_rows = {"1d": 0, "2d": 0}, []
    for b in plan:
        bb, s = b.ids.shape
        cs = sparse_chunk(s, bb, config.n_vocab, budget)
        r = route(bb * cs, 768, config.n_vocab, w.qtype, torch.bfloat16).kernel
        dec["2d" if r == "2d" else "1d"] += s // cs
        dec_rows.append([bb, s, cs, r])
    out, counts = _counted(counters, lambda: sp.sparse_tokens(lists, k=256))
    f = len(plan)
    check(counts["q4_matmul"] == 72 * f + dec["1d"] and counts["q4_matmul_2d"] == dec["2d"]
          and counts["attn_bse_keybias"] == 12 * f
          and sum(counts[k] for k in ATTENTION) == 12 * f, f"splade launches {counts} {dec}")
    check(len(out) == len(lists) and all(0 < len(i) <= 256 and np.all(v > 0)
                                         and np.all(np.diff(v) <= 0) for i, v in out),
          "splade outputs")
    best = _best_s(lambda: sp.sparse_tokens(lists, k=256), 3)

    # the decoder at the largest planned batch's chunk
    bb, s, cs, _ = max(dec_rows, key=lambda r: r[0] * r[2])
    m, k, n = bb * cs, 768, config.n_vocab
    gen = torch.Generator(device="cpu").manual_seed(21)
    x = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
    bias = sp.params["mlm"]["bias"]
    wd = dequant_weight(w, torch.bfloat16)
    nbytes = (x.numel() * 2 + w.qs.numel() * w.qs.element_size() + w.scales.numel() * 4
              + n * 4 + m * n * 2)
    c = _attention_case("q4_matmul/splade", lambda *a: q4_matmul(*a, bias=bias),
                        lambda *a: q4_matmul_plain(*a, bias),
                        lambda: torch.addmm(bias.to(torch.bfloat16), x, wd), (x, w), nbytes,
                        2.0 * m * k * n, peaks, True, m=m, k=k, n=n, qtype="Q4_0",
                        route=route(m, k, n, w.qtype, torch.bfloat16).kernel)
    got2 = _q4_matmul_2d(x, w, bias)
    err2, rel2 = _rel_err(got2, q4_matmul_plain(x, w, bias))
    c["k8_forced_ms"] = gpu_ms(lambda: _q4_matmul_2d(x, w, bias))
    c["k8_forced_max_abs_err"] = err2
    emit({"phase": "kernel_check", "kernel": "q4_matmul_2d/splade", "m": m, "k": k, "n": n,
          "max_abs_err": err2, "rel_err": rel2, "ms": c["k8_forced_ms"],
          "ok": _within(torch.bfloat16, err2, rel2)})
    check(_within(torch.bfloat16, err2, rel2), f"K8 forced at the decoder: {rel2}")
    del x, wd, got2

    # the cosines over whole vectors (k = n_vocab: every positive term): a
    # random-weight model has ~half the vocabulary positive, so its k = 256
    # cut falls where the weights lie closer than bf16's step, and which of
    # those terms a bf16 path keeps is a tie-break (reported apart)
    few = lists[:64]
    cpu = Engine(sp.params, config, sp.tokenizer, sp.special_ids, device="cpu")
    cpu_bf16 = Engine(sp.params, config, sp.tokenizer, sp.special_ids, device="cpu",
                      opts=opts)
    gpu_f32 = Engine(sp.params, config, sp.tokenizer, sp.special_ids, device="cuda")
    ref = cpu.sparse_tokens(few, k=256)
    got_f32 = gpu_f32.sparse_tokens(few, k=256)
    same_ids = all(set(a[0].tolist()) == set(b[0].tolist()) for a, b in zip(got_f32, ref))
    w_err = max(float(np.abs(_sparse_vec([a], n) - _sparse_vec([b], n)).max())
                for a, b in zip(got_f32, ref))
    whole = {name: _sparse_vec(e.sparse_tokens(few, k=n), n)
             for name, e in (("card_bf16", sp), ("cpu_f32", cpu), ("cpu_bf16", cpu_bf16))}
    cos = {"bf16_vs_cpu_f32": _min_cos(whole["card_bf16"], whole["cpu_f32"]),
           "bf16_vs_cpu_bf16": _min_cos(whole["card_bf16"], whole["cpu_bf16"])}
    cos_k256 = {"bf16_vs_cpu_f32": _min_cos(_sparse_vec(out[:64], n), _sparse_vec(ref, n))}
    emit({"phase": "splade", "model": config.name, "weights": "q4_0", "activations": "bfloat16",
          "sentences": len(lists), "tokens": sum(len(t) for t in lists), "k": 256,
          "sentences_per_sec": len(lists) / best, "batches": [list(b.ids.shape) for b in plan],
          "decoder_chunks": dec_rows, "launches": counts,
          "mean_terms": float(np.mean([len(i) for i, _ in out])),
          "f32_same_ids": same_ids, "f32_max_abs_weight_err": w_err,
          "min_cosine": cos, "thresholds": {"bf16_vs_cpu_f32": 0.995, "bf16_vs_cpu_bf16": 0.999},
          "min_cosine_k256_reported": cos_k256,
          "positive_terms": float(np.mean((whole["cpu_f32"] > 0).sum(1))),
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    check(same_ids and w_err <= 1e-4, f"splade f32 vs CPU: ids {same_ids} err {w_err}")
    check(cos["bf16_vs_cpu_f32"] >= 0.995 and cos["bf16_vs_cpu_bf16"] >= 0.999,
          f"splade bf16 cosine {cos}")
    return sp, counts, c, dec, max(plan, key=lambda b: b.ids.size)


def _colbert_docs(n: int, seed: int) -> list[str]:
    """n passages of 55-155 words with a punctuation mark every 8 words
    (ColBERT's skiplist drops them from scoring)."""
    from embedding_cpp_tpu_torch.tokenizer.testvocab import _COMMON_WORDS

    rng = np.random.default_rng(seed)
    words = np.array(_COMMON_WORDS)
    out = []
    for m in rng.integers(55, 156, n):
        toks = list(rng.choice(words, size=int(m)))
        for i in range(8, len(toks), 8):
            toks[i] += rng.choice([",", ".", ";", "?"])
        out.append(" ".join(toks))
    return out


def phase_colbert(counters, token_lists) -> tuple:
    """colbertv2.0's geometry (BERT-base, the 768 -> 128 projection,
    query_maxlen 32, [unused0]/[unused1] markers, [MASK] augmentation, the
    punctuation skiplist; Q4_0 from seed 0, bf16; vocab cut to 1000): 64
    queries, each reranking the same 32 documents of 64-180 tokens through
    maxsim_rerank: documents/s; K1/K3 launches per forward; 2 queries'
    scores against the port's f32 CPU path: the card's f32 path within
    1e-5 relative with the same order, the bf16 path Pearson >= 0.999 with
    the same top-1."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import BertConfig, ComputeOptions
    from embedding_cpp_tpu_torch.tokenizer.testvocab import build_vocab

    vocab = build_vocab(1000)
    config = BertConfig(n_vocab=1000, n_ctx=512, n_embd=768, n_layer=12, n_head=12, n_ff=3072,
                        colbert_dim=128, query_maxlen=32, mask_punctuation=True,
                        q_marker_id=vocab["[unused0]"], d_marker_id=vocab["[unused1]"],
                        mask_id=vocab["[MASK]"], name="colbertv2.0-synthetic")
    opts = ComputeOptions(dtype="bfloat16")
    cb = Engine.synthetic(config, "q4_0", seed=0, opts=opts, device="cuda")
    queries = synthetic_sentences(64, seed=13)
    docs = _colbert_docs(32, seed=14)
    doc_tokens = cb.colbert_doc_tokens(docs)
    check(all(t[1] == config.d_marker_id for t in doc_tokens)
          and 64 <= min(map(len, doc_tokens)) and max(map(len, doc_tokens)) <= 180,
          f"colbert doc framing {sorted(map(len, doc_tokens))[:3]}")
    q_ids, q_mask = cb.colbert_query_ids(queries[:1])
    check(q_ids.shape == (1, 32) and q_ids[0, 1] == config.q_marker_id
          and (q_ids[0][q_mask[0] == 0] == config.mask_id).all(), "colbert query framing")
    check(len(cb.colbert_skiplist()) > 0, "colbert skiplist")
    per_query = 1 + len(cb.score_plan(doc_tokens))
    ranked, counts = _counted(counters, lambda: [cb.maxsim_rerank(q, docs) for q in queries])
    f = 64 * per_query
    check(counts["q4_matmul"] == 72 * f and counts["attn_bse_keybias"] == 12 * f
          and sum(counts[k] for k in ATTENTION) == 12 * f, f"colbert launches {counts}")
    best = _best_s(lambda: [cb.maxsim_rerank(q, docs) for q in queries], 2)

    gpu_f32 = Engine(cb.params, config, cb.tokenizer, cb.special_ids, device="cuda")
    cpu = Engine(cb.params, config, cb.tokenizer, cb.special_ids, device="cpu")
    vs = []
    for q, r in zip(queries[:2], ranked[:2]):
        ref = cpu.maxsim(q, docs)
        got = gpu_f32.maxsim(q, docs)
        bf = np.empty(len(docs), np.float32)
        bf[[x["index"] for x in r]] = [x["relevance_score"] for x in r]
        vs.append({"f32_max_rel_err": float(np.max(np.abs(got - ref) / np.abs(ref))),
                   "f32_same_order": bool((np.argsort(-got, kind="stable")
                                           == np.argsort(-ref, kind="stable")).all()),
                   "bf16_pearson": _pearson(bf, ref),
                   "bf16_top1": [int(np.argmax(bf)), int(np.argmax(ref))],
                   "score_std": float(np.std(ref))})
    emit({"phase": "colbert", "model": config.name, "weights": "q4_0", "activations": "bfloat16",
          "queries": len(queries), "documents": len(docs),
          "document_tokens": sum(map(len, doc_tokens)), "forwards_per_query": per_query,
          "documents_per_sec": len(queries) * len(docs) / best, "launches": counts,
          "vs_cpu": vs, "thresholds": {"f32_max_rel_err": 1e-5, "bf16_pearson": 0.999},
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    check(all(v["f32_max_rel_err"] <= 1e-5 and v["f32_same_order"] for v in vs),
          f"colbert f32 vs CPU {vs}")
    check(all(v["bf16_pearson"] >= 0.999 and v["bf16_top1"][0] == v["bf16_top1"][1]
              for v in vs), f"colbert bf16 vs CPU {vs}")
    return cb, counts, max(cb.score_plan(doc_tokens), key=lambda b: b.ids.size)


def phase_nomic_unaligned(counters, base) -> dict:
    """nomic-embed-text-v1.5 at Engine(pack_seq=2044, packing="always"):
    rows of 2044 tokens (S % 8 != 0, XLA in the reference) run K6 padded to
    2048 inside the attention call (windowed by the bound 512); the 512
    chunks' launches asserted, min cosine >= 0.999 against the port's f32
    CPU path on 16 chunks."""
    from embedding_cpp_tpu_torch import Engine

    def engine(card: bool, **kw):
        """On the card in the phase's bf16, or the f32 CPU reference."""
        return Engine(base.params, base.config, base.tokenizer, base.special_ids,
                      opts=base.opts if card else None, device="cuda" if card else "cpu",
                      pack_seq=2044, **kw)

    eng = engine(True, packing="always")
    chunks = _chunks(512, 128, 512, seed=0, special=base.special_ids)
    plan = _packed_plan(eng, chunks)
    check(sum(len(pb.orig) for pb in plan) == len(chunks)
          and all(pb.ids.shape[1] == 2044 for pb in plan), "nomic 2044 plan")
    _, counts = _run_counted(counters, eng, chunks, {"attn_seg_window": len(plan)},
                             "chunks at pack_seq 2044")
    few = chunks[:16]
    got, few_counts = _run_counted(counters, eng, few,
                                   {"attn_seg_window": len(_packed_plan(eng, few))},
                                   "16 chunks at pack_seq 2044")
    cos = _min_cos(got, engine(False, packing="always").embed_tokens(few))
    emit({"phase": "nomic_unaligned", "pack_seq": 2044, "chunks": len(chunks),
          "batch_shapes": [list(pb.ids.shape) for pb in plan], "launches": counts,
          "min_cosine_vs_cpu": cos, "threshold": COSINE_VS_CPU})
    check(cos >= COSINE_VS_CPU, f"nomic 2044 cosine vs CPU {cos}")
    return {k: counts[k] + few_counts[k] for k in counts}


def _texts_frame(texts) -> bytes:
    return struct.pack("<I", len(texts)) + b"".join(
        struct.pack("<I", len(t.encode())) + t.encode() for t in texts)


def phase_token_frames(splade, colbert) -> None:
    """The sparse frame \\x01TPW on the SPLADE engine (== encode_sparse) and
    the MaxSim frame \\x01TPX on the ColBERT engine (== maxsim_rerank)."""
    from embedding_cpp_tpu_torch.runtime.server import MAGIC_MAXSIM, MAGIC_SPARSE

    texts = synthetic_sentences(3, seed=21)
    want = splade.encode_sparse(texts, k=64)
    with _serving(splade) as port, socket.create_connection(("127.0.0.1", port), 10) as s:
        s.settimeout(120)
        _recv(s, 4)
        s.sendall(MAGIC_SPARSE + struct.pack("<I", 64) + _texts_frame(texts))
        (n,) = struct.unpack("<I", _recv(s, 4))
        got = []
        for _ in range(n):
            (m,) = struct.unpack("<I", _recv(s, 4))
            got.append((np.frombuffer(_recv(s, 4 * m), np.int32),
                        np.frombuffer(_recv(s, 4 * m), np.float32)))
    sparse_ok = n == len(texts) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(got, want))
    query, docs = texts[0], _colbert_docs(6, seed=22)
    want_rank = colbert.maxsim_rerank(query, docs, top_n=4)
    with _serving(colbert) as port, socket.create_connection(("127.0.0.1", port), 10) as s:
        s.settimeout(120)
        _recv(s, 4)
        s.sendall(MAGIC_MAXSIM + struct.pack("<II", 4, len(query.encode())) + query.encode()
                  + _texts_frame(docs))
        (m,) = struct.unpack("<I", _recv(s, 4))
        idx = np.frombuffer(_recv(s, 4 * m), np.int32).tolist()
        scores = np.frombuffer(_recv(s, 4 * m), np.float32)
    err = float(np.abs(scores - [r["relevance_score"] for r in want_rank]).max())
    emit({"phase": "token_frames", "sparse_texts": n, "sparse_equal": sparse_ok,
          "maxsim_indices": idx, "maxsim_max_abs_score_err": err})
    check(sparse_ok, "the TPW reply differs from encode_sparse")
    check(idx == [r["index"] for r in want_rank] and err <= 1e-6,
          f"the TPX reply {idx} differs from maxsim_rerank {want_rank}")


# --- retrieval: the three on-device indexes ----------------------------------

QUERY_K = 10


def _event_ms(fn, runs: int = 5) -> float:
    """Median CUDA-event time of fn() over `runs` calls after a warm-up.
    The calls fetch their results to the host, so this is the call's
    latency, its host work included."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _filled(index, texts):
    """`index` after add(texts), its device work finished."""
    import torch

    index.add(texts)
    torch.cuda.synchronize()
    return index


def _ties_only(ids, ref_ids, ref_scores, tol: float) -> bool:
    """Whether top-k ids agree with a reference's, [Q, k+1] ranked ids and
    scores, but where the reference's scores tie within `tol`: a position
    may hold another id only where its reference score is that close to a
    neighbour's (the (k+1)-th included)."""
    k = ids.shape[1]
    for row, rrow, srow in zip(ids, ref_ids, ref_scores):
        for j in np.nonzero(row != rrow[:k])[0]:
            near = [abs(srow[j] - srow[x]) <= tol * max(1.0, abs(srow[j]))
                    for x in (j - 1, j + 1) if 0 <= x < len(srow)]
            if not any(near):
                return False
    return True


def _brute_force(q: np.ndarray, corpus: np.ndarray, k: int, block: int = 1 << 17) -> tuple:
    """Exact f64 top-k of unit queries against unit corpus rows (numpy, in
    row blocks): ([Q, k] ids, scores), equal scores by the lower id."""
    q = q.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scores = np.concatenate([q @ corpus[lo: lo + block].astype(np.float64).T
                             for lo in range(0, len(corpus), block)], axis=1)
    part = np.argpartition(-scores, k - 1, axis=1)[:, :k]
    top = np.take_along_axis(scores, part, 1)
    ids = np.take_along_axis(part, np.lexsort((part, -top), axis=-1), 1)
    return ids, np.take_along_axis(scores, ids, 1)


def _same_ranking(got: tuple, exact: tuple) -> bool:
    """A candidates search at C >= n against exact search's [Q, k+1]
    result: its stage 2 sums in another order, so ids agree but for ties
    within 1e-5, and scores within 1e-5 relative."""
    k = got[0].shape[1]
    return _ties_only(got[0], *exact, 1e-5) and np.allclose(got[1], exact[1][:, :k], rtol=1e-5,
                                                            atol=0)


def _recall(ids: np.ndarray, ref: np.ndarray) -> float:
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, ref)]))


def phase_vector_index(counters, engine) -> dict:
    """VectorIndex on the MiniLM main-path engine (bf16 activations): the
    2758-sentence corpus through add() (Engine.embed_tokens_device: K1 and
    K2 on the card, the vectors never leave it) into a bf16 and an f32
    corpus, 512 queries at k = 10.  Gates: K1 and the attention launched as
    the plan gives them; both corpora on the card; the f32 index's top-10
    equals an f64 numpy brute force over its fetched vectors, searched while
    the process allows TF32; the bf16 index's equals one over its fetched
    bf16 rows and bf16-rounded queries (ties within 1e-6 aside).  The bf16
    index's recall against the f32 one is reported here (the random-weight
    model's embeddings cluster) and gated at the 1M-vector scale."""
    import torch

    from embedding_cpp_tpu_torch.runtime.search import VectorIndex

    texts, queries = synthetic_sentences(2758, seed=0), synthetic_sentences(512, seed=31)
    t0 = time.perf_counter()
    forwards = _expected_forwards(engine, engine.tokenize_batch(texts))
    tokenize_s = time.perf_counter() - t0
    index, counts = _counted(counters, lambda: _filled(VectorIndex(engine), texts))
    attn = counts["attn_bse_packed"] + counts["attn_bse_keybias"]
    check(counts["q4_matmul"] == 36 * forwards and attn == 6 * forwards
          and counts["attn_bse_packed"] > 0, f"vector index ingest launches {counts}")
    ingest_s = _best_s(lambda: _filled(VectorIndex(engine), texts), 3)
    f32 = _filled(VectorIndex(engine, dtype="float32"), texts)
    check(index._rows.bufs[0]["vectors"].device.type == f32._rows.bufs[0]["vectors"].device.type
          == "cuda", "corpus not on the card")
    qvecs = engine.encode_queries(queries)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 allowed: the index must not use it
    try:
        ids32, s32 = f32.search_vectors(qvecs, QUERY_K)
    finally:
        torch.set_float32_matmul_precision(prev)
    ids16, s16 = index.search_vectors(qvecs, QUERY_K)
    n = len(texts)
    ref32 = _brute_force(qvecs, f32._rows.gather(n, "vectors").cpu().numpy(), QUERY_K + 1)
    q16 = torch.from_numpy(qvecs / np.linalg.norm(qvecs, axis=1, keepdims=True)).bfloat16()
    ref16 = _brute_force(q16.float().numpy(),
                         index._rows.gather(n, "vectors").float().cpu().numpy(), QUERY_K + 1)
    ok32 = _ties_only(ids32, *ref32, 1e-6)
    ok16 = _ties_only(ids16, *ref16, 1e-6)
    err32 = float(np.abs(s32 - ref32[1][:, :QUERY_K]).max())
    search_s = _best_s(lambda: index.search(queries, QUERY_K), 3)
    out = {"phase": "vector_index", "model": engine.config.name, "documents": n,
           "queries": len(queries), "k": QUERY_K, "launches": counts, "forwards": forwards,
           "documents_per_sec": n / ingest_s, "tokenize_s": tokenize_s,
           "queries_per_sec": len(queries) / search_s,
           "search_ms_512_queries_bf16": _event_ms(lambda: index.search_vectors(qvecs, QUERY_K)),
           "search_ms_512_queries_f32": _event_ms(lambda: f32.search_vectors(qvecs, QUERY_K)),
           "f32_ids_equal_brute_force": ok32, "f32_max_abs_score_err": err32,
           "bf16_ids_equal_brute_force": ok16,
           "bf16_recall_at_10_vs_f32": _recall(ids16, ids32),
           "mean_top10_gap": float(np.mean(s32[:, 0] - s32[:, -1])),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    check(ok32 and err32 <= 1e-5, f"f32 index vs brute force: {ok32} {err32}")
    check(ok16, "bf16 index vs its brute force")
    return {"counts": counts, "documents_per_sec": out["documents_per_sec"],
            "queries_per_sec": out["queries_per_sec"]}


def phase_sparse_index(counters, splade) -> dict:
    """SparseIndex on the SPLADE engine: the corpus through add()
    (encode_sparse at k 256: K1 / K8 and K3 on the card; padded COO rows on
    the card), 512 queries at k = 10, exact and candidates=256 (P = 8), and
    candidates >= n, which must equal exact; the device search against the
    host backend (device=False) on the same pairs: ids equal but for ties
    within 1e-5, scores within 1e-5 relative.  Hybrid: the ContinuousBatcher's
    hybrid index (the dense add on the same engine) and its rrf_fuse search,
    equal to rrf_fuse of its two indexes' rankings."""
    import torch

    from embedding_cpp_tpu_torch.runtime.server import ContinuousBatcher
    from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex, rrf_fuse

    texts, queries = synthetic_sentences(2758, seed=0), synthetic_sentences(512, seed=31)
    index, counts = _counted(counters, lambda: _filled(SparseIndex(splade), texts))
    check(counts["q4_matmul"] > 0 and counts["attn_bse_keybias"] > 0,
          f"sparse index ingest launches {counts}")
    check(all(t.device.type == "cuda" for t in index._rows.bufs[0].values()),
          "sparse corpus not on the card")
    ingest_s = _best_s(lambda: _filled(SparseIndex(splade), texts), 2)
    tokenize_s = _best_s(lambda: splade.tokenize_batch(texts), 1)
    pairs = splade.encode_sparse(queries, k=256)
    n = len(index)
    exact = index.search_vectors(pairs, QUERY_K + 1)
    every = index.search_vectors(pairs, QUERY_K, candidates=n)
    cand = index.search_vectors(pairs, QUERY_K, candidates=256)
    host = SparseIndex(device=False)
    host.add_vectors(list(zip(index._indices, index._values)))
    ref = host.search_vectors(pairs, QUERY_K + 1)
    same_host = _ties_only(exact[0][:, :QUERY_K], *ref, 1e-5)
    host_err = float(np.max(np.abs(exact[1] - ref[1]) / np.maximum(np.abs(ref[1]), 1e-12)))
    same_every = _same_ranking(every, exact)
    b = ContinuousBatcher(splade)
    hyb_counts = _counted(counters, lambda: b.hybrid_index_texts(texts))[1]
    fused = b.hybrid_search_texts(queries, QUERY_K)
    want = rrf_fuse([b.index.search(queries, QUERY_K)[0],
                     b.sparse_index.search(queries, QUERY_K)[0]], QUERY_K)
    same_fused = all(np.array_equal(x, y) for x, y in zip(fused, want))
    out = {"phase": "sparse_index", "model": splade.config.name, "documents": n,
           "queries": len(queries), "k": QUERY_K, "nnz_width": index.nnz_width,
           "launches": counts, "hybrid_launches": hyb_counts,
           "documents_per_sec": n / ingest_s, "tokenize_s": tokenize_s,
           "queries_per_sec": len(queries) / _best_s(lambda: index.search(queries, QUERY_K), 2),
           "search_ms_512_queries": _event_ms(lambda: index.search_vectors(pairs, QUERY_K)),
           "candidates_256_ms_512_queries": _event_ms(
               lambda: index.search_vectors(pairs, QUERY_K, candidates=256)),
           "candidates_256_recall_at_10": _recall(cand[0], exact[0][:, :QUERY_K]),
           "candidates_n_equals_exact": same_every, "host_ids_equal": same_host,
           "host_max_rel_score_err": host_err, "hybrid_equals_rrf_of_both": same_fused,
           "hybrid_queries_per_sec": len(queries) / _best_s(
               lambda: b.hybrid_search_texts(queries, QUERY_K), 2),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    check(same_host and host_err <= 1e-5, f"sparse device vs host: {same_host} {host_err}")
    check(same_every, "sparse candidates >= n differ from exact")
    check(same_fused and len(b.index) == len(b.sparse_index) == n, "hybrid search")
    total = {k: counts[k] + hyb_counts[k] for k in counts}
    return {"counts": total, "documents_per_sec": out["documents_per_sec"],
            "queries_per_sec": out["queries_per_sec"]}


def phase_maxsim_index(counters, colbert) -> dict:
    """MaxSimIndex on the ColBERT engine (doc_maxlen 256, bf16 corpus): the
    corpus through add() (Engine.token_states_device: K1 and K3 on the
    card, the [D] framing and the skiplist), 64 queries at k = 10, exact,
    candidates=256, and candidates >= n, which must equal exact; an f32
    index over PR 15's 32 ColBERT documents, whose exact scores must equal
    Engine.maxsim's within 1e-5 relative.  Documents scored per second
    stand beside maxsim_rerank's (the colbert phase)."""
    import torch

    from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex

    texts, queries = synthetic_sentences(2758, seed=0), synthetic_sentences(64, seed=13)
    index, counts = _counted(counters, lambda: _filled(MaxSimIndex(colbert), texts))
    check(counts["q4_matmul"] > 0 and counts["attn_bse_keybias"] > 0,
          f"MaxSim index ingest launches {counts}")
    check(all(t.device.type == "cuda" for t in index._rows.bufs[0].values()),
          "MaxSim corpus not on the card")
    ingest_s = _best_s(lambda: _filled(MaxSimIndex(colbert), texts), 2)
    tokenize_s = _best_s(lambda: colbert.colbert_doc_tokens(texts), 1)
    qv = colbert.colbert_query_vectors(queries)
    n = len(index)
    exact = index.search_token_vectors(qv, QUERY_K + 1)
    every = index.search_token_vectors(qv, QUERY_K, candidates=n)
    cand = index.search_token_vectors(qv, QUERY_K, candidates=256)
    same_every = _same_ranking(every, exact)
    docs = _colbert_docs(32, seed=14)
    f32 = MaxSimIndex(colbert, dtype="float32")
    f32.add(docs)
    rel = 0.0
    for q in queries[:2]:
        ids, scores = f32.search([q], len(docs))
        want = colbert.maxsim(q, docs)[ids[0]]
        rel = max(rel, float(np.max(np.abs(scores[0] - want) / np.abs(want))))
    exact_ms = _event_ms(lambda: index.search_token_vectors(qv, QUERY_K))
    out = {"phase": "maxsim_index", "model": colbert.config.name, "documents": n,
           "doc_maxlen": index.doc_maxlen, "queries": len(queries), "k": QUERY_K,
           "launches": counts, "documents_per_sec": n / ingest_s, "tokenize_s": tokenize_s,
           "queries_per_sec": len(queries) / _best_s(lambda: index.search(queries, QUERY_K), 2),
           "search_ms_64_queries": exact_ms,
           "documents_scored_per_sec": len(queries) * n / exact_ms * 1e3,
           "candidates_256_ms_64_queries": _event_ms(
               lambda: index.search_token_vectors(qv, QUERY_K, candidates=256)),
           "candidates_256_recall_at_10": _recall(cand[0], exact[0][:, :QUERY_K]),
           "candidates_n_equals_exact": same_every,
           "f32_max_rel_err_vs_maxsim": rel,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    check(same_every, "MaxSim candidates >= n differ from exact")
    check(rel <= 1e-5, f"MaxSim f32 index vs Engine.maxsim: {rel}")
    return {"counts": counts, "documents_per_sec": out["documents_per_sec"],
            "queries_per_sec": out["queries_per_sec"]}


def phase_index_scale(engine, colbert, peaks, f32_rate: float) -> dict:
    """The indexes at deployment sizes, on synthetic vectors from a seed: 1M
    unit vectors of 384 (bf16, 768 MB; and f32), 100,000 sparse documents of
    256 terms over 30522 (205 MB), 10,000 MaxSim documents of 256 tokens x
    128 (bf16, 655 MB).  One 64-query search of each timed with CUDA events
    (k = 10; sparse and MaxSim also with candidates), the dense one also as
    its device work alone beside its bound (the corpus read once).  Gates:
    the 1M f32 index's top-10 equals an f64 numpy brute force over the
    fetched vectors (ties within 1e-6 aside), and the bf16 index's top-10
    recall against the f32 one, over 512 queries, is >= 0.99."""
    import torch

    from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex
    from embedding_cpp_tpu_torch.runtime.search import (
        VectorIndex,
        exact_f32,
        select_topk,
        similarity,
        unit,
    )
    from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    n, e, nq = 1_000_000, 384, 64
    v = torch.randn(n, e, device=dev, generator=gen)
    idx16, idx32 = VectorIndex(engine), VectorIndex(engine, dtype="float32")
    t0 = time.perf_counter()
    idx16.add_vectors(v)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    idx32.add_vectors(v)
    del v
    # 512 queries for the recall (its spread over 64 would be ~0.004), the
    # first 64 for the timing and the brute force
    q_all = torch.randn(512, e, device=dev, generator=gen).cpu().numpy()
    q = q_all[:nq]
    recall = _recall(idx16.search_vectors(q_all, QUERY_K)[0],
                     idx32.search_vectors(q_all, QUERY_K)[0])
    ids32, s32 = idx32.search_vectors(q, QUERY_K)
    ref = _brute_force(q, idx32._rows.gather(n, "vectors").cpu().numpy(), QUERY_K + 1)
    same = _ties_only(ids32, *ref, 1e-6)
    qd = unit(torch.from_numpy(q).to(dev)).bfloat16()
    corpus = idx16._rows.gather(n, "vectors")
    with exact_f32():
        device_ms = gpu_ms(lambda: select_topk(similarity(qd, corpus), QUERY_K), samples=10)
        product_ms = gpu_ms(lambda: similarity(qd, corpus), samples=10)
        scores = similarity(qd, corpus)
        select_ms = gpu_ms(lambda: select_topk(scores, QUERY_K), samples=10)
        del scores
    dense_bound, dense_by = bound_ms(n * e * 2 + nq * e * 2 + nq * QUERY_K * 8,
                                     2.0 * nq * e * n, peaks)
    dense = {"vectors": n, "dim": e, "corpus_bytes": corpus.numel() * 2,
             "add_vectors_s": add_s,
             "search_ms_bf16": _event_ms(lambda: idx16.search_vectors(q, QUERY_K)),
             "search_ms_f32": _event_ms(lambda: idx32.search_vectors(q, QUERY_K)),
             "device_ms_bf16": device_ms, "product_ms_bf16": product_ms,
             "select_ms": select_ms, "bound_ms": dense_bound, "bound_by": dense_by,
             "f32_ids_equal_brute_force": same,
             "f32_max_abs_score_err": float(np.abs(s32 - ref[1][:, :QUERY_K]).max()),
             "bf16_recall_at_10_vs_f32_512_queries": recall}
    del idx16, idx32, corpus, qd
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    ns, kd, vocab = 100_000, 256, 30522
    draws = np.sort(rng.integers(0, vocab, (ns, 320)), axis=1)
    dup = np.zeros(draws.shape, bool)
    dup[:, 1:] = draws[:, 1:] == draws[:, :-1]
    check(int((~dup).sum(1).min()) >= kd, "sparse synthetic rows")
    ids = np.take_along_axis(draws, np.argsort(dup, axis=1, kind="stable"), 1)[:, :kd]
    ids = np.ascontiguousarray(ids, np.int32)
    weights = rng.random((ns, kd), dtype=np.float32)
    sp = SparseIndex(device=dev, nnz_width=kd)
    t0 = time.perf_counter()
    sp.add_vectors(list(zip(ids, weights)))
    torch.cuda.synchronize()
    sp_add_s = time.perf_counter() - t0
    sq = [(rng.choice(vocab, 48, replace=False).astype(np.int32),
           rng.random(48, dtype=np.float32)) for _ in range(nq)]
    sp_bound, sp_by = bound_ms(ns * kd * 8 + nq * vocab * 4, 2.0 * nq * ns * kd, peaks)
    sparse = {"documents": ns, "nnz_width": kd, "corpus_bytes": ns * kd * 8,
              "add_vectors_s": sp_add_s,
              "search_ms": _event_ms(lambda: sp.search_vectors(sq, QUERY_K), runs=3),
              "candidates_1000_ms": _event_ms(
                  lambda: sp.search_vectors(sq, QUERY_K, candidates=1000), runs=3),
              "candidates_1000_recall_at_10": _recall(
                  sp.search_vectors(sq, QUERY_K, candidates=1000)[0],
                  sp.search_vectors(sq, QUERY_K)[0]),
              "bound_ms": sp_bound, "bound_by": sp_by}
    del sp, ids, weights, draws, dup
    torch.cuda.empty_cache()

    nm, sd, em = 10_000, 256, 128
    ms = MaxSimIndex(colbert, doc_maxlen=sd, capacity=nm)
    t0 = time.perf_counter()
    for lo in range(0, nm, 2000):
        ms.add_token_vectors(list(rng.standard_normal((2000, sd, em), dtype=np.float32)))
    torch.cuda.synchronize()
    ms_add_s = time.perf_counter() - t0
    mq = list(rng.standard_normal((nq, 32, em), dtype=np.float32))
    ms_bound, ms_by = bound_ms(nm * sd * (em * 2 + 1) + nq * 32 * em * 4,
                               2.0 * nq * 32 * nm * sd * em, (peaks[0], f32_rate))
    maxsim = {"documents": nm, "doc_maxlen": sd, "dim": em,
              "corpus_bytes": ms._rows.bufs[0]["corpus"].numel() * 2,
              "add_token_vectors_s": ms_add_s,
              "search_ms": _event_ms(lambda: ms.search_token_vectors(mq, QUERY_K), runs=3),
              "candidates_256_ms": _event_ms(
                  lambda: ms.search_token_vectors(mq, QUERY_K, candidates=256), runs=3),
              "bound_ms": ms_bound, "bound_by": ms_by, "bound_rate": "f32 (the similarity)"}
    del ms
    torch.cuda.empty_cache()
    out = {"phase": "index_scale", "queries": nq, "k": QUERY_K, "dense": dense,
           "sparse": sparse, "maxsim": maxsim,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    check(same and dense["f32_max_abs_score_err"] <= 1e-5,
          f"1M f32 index vs brute force: {same} {dense['f32_max_abs_score_err']}")
    check(recall >= 0.99, f"1M bf16 recall@10 vs f32: {recall}")
    return out


def phase_index_frames(engine, splade, colbert) -> None:
    """The 8 index frames over TCP, each against the direct index call on
    the same engine: \\x01TPB/\\x01TPS (VectorIndex, MiniLM), \\x01TPJ/\\x01TPK
    (MaxSimIndex, ColBERT), \\x01TPY/\\x01TPZ (SparseIndex) and
    \\x01TPF/\\x01TPG (hybrid, rrf_fuse) on the SPLADE engine: a search before
    its index gets the error frame, the index frame's total, then `u32 n |
    u32 k | ids | scores` equal to the direct call's."""
    from embedding_cpp_tpu_torch.runtime import server as S
    from embedding_cpp_tpu_torch.runtime.maxsim_search import MaxSimIndex
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex
    from embedding_cpp_tpu_torch.runtime.sparse_search import SparseIndex

    docs, queries = synthetic_sentences(64, seed=41), synthetic_sentences(8, seed=42)

    def direct(cls, eng):
        index = cls(eng)
        index.add(docs)
        return index.search(queries, QUERY_K)

    def hybrid():
        b = S.ContinuousBatcher(splade)
        b.hybrid_index_texts(docs)
        return b.hybrid_search_texts(queries, QUERY_K)

    cases = [(engine, S.MAGIC_INDEX, S.MAGIC_SEARCH, lambda: direct(VectorIndex, engine)),
             (colbert, S.MAGIC_MAXSIM_INDEX, S.MAGIC_MAXSIM_SEARCH,
              lambda: direct(MaxSimIndex, colbert)),
             (splade, S.MAGIC_SPARSE_INDEX, S.MAGIC_SPARSE_SEARCH,
              lambda: direct(SparseIndex, splade)),
             (splade, S.MAGIC_HYBRID_INDEX, S.MAGIC_HYBRID_SEARCH, hybrid)]
    replies = []
    for eng, index_magic, search_magic, want_fn in cases:
        search = search_magic + struct.pack("<I", QUERY_K) + _texts_frame(queries)
        with _serving(eng) as port, socket.create_connection(("127.0.0.1", port), 10) as s:
            s.settimeout(120)
            _recv(s, 4)
            s.sendall(search)
            flag, ln = struct.unpack("<II", _recv(s, 8))
            error = _recv(s, ln).decode()
            s.sendall(index_magic + _texts_frame(docs))
            (total,) = struct.unpack("<I", _recv(s, 4))
            s.sendall(search)
            nrow, k = struct.unpack("<II", _recv(s, 8))
            ids = np.frombuffer(_recv(s, 4 * nrow * k), np.int32).reshape(nrow, k)
            scores = np.frombuffer(_recv(s, 4 * nrow * k), np.float32).reshape(nrow, k)
        want_ids, want_scores = want_fn()
        err = float(np.abs(scores - want_scores).max())
        replies.append({"frames": [index_magic.decode("latin-1")[1:],
                                   search_magic.decode("latin-1")[1:]],
                        "before_index": error, "total": total, "shape": [nrow, k],
                        "ids_equal": bool(np.array_equal(ids, want_ids)),
                        "max_abs_score_err": err})
        check(flag == 0xFFFFFFFF and ("no " in error or "both" in error),
              f"{search_magic!r} before its index: {error!r}")
        check(total == len(docs) and (nrow, k) == (len(queries), QUERY_K)
              and np.array_equal(ids, want_ids) and err <= 1e-6,
              f"{search_magic!r} reply differs from the direct call")
    emit({"phase": "index_frames", "documents": len(docs), "queries": len(queries),
          "frames": replies})


# --- the HTTP surface and the CLI -------------------------------------------

def phase_http(counters, files: dict, index_docs_per_sec: float, out_dir) -> dict:
    """The server's HTTP surface on the card: `serve(..., http_port=,
    extra_engines=)` over the formats phase's port-written Q4_0 GGUF (the
    server's defaults: bf16, int8 transfer), its f16 GGUF as a second model.
    256 texts a request through /v1/embeddings, float and base64, each reply
    against engine.encode at COSINE_SERVER.  Requests/s on one kept-alive
    connection: windows of HTTP_WINDOW_S seconds, float and base64 in turn,
    the median of HTTP_REPEATS windows each, the kernels' launches counted
    over all of them (counts set to 0 just before, read just after); beside
    them the server's engine time a request (the metrics' eval timer), and
    outside the server the engine's own call, the tokenizer and the float
    rendering on the same texts; a few requests of each encoding under
    torch.profiler (device busy time a request against its wall time);
    /v1/tokenize against engine.tokenize_batch;
    /v1/index + /v1/search (each document its own top hit); /metrics; the
    second model's route.  Then VectorIndex ingest of the corpus with the
    native tokenizer and with the pure-Python engine, beside the
    vector_index phase's rate."""
    import http.client

    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions
    from embedding_cpp_tpu_torch.runtime.search import VectorIndex
    from embedding_cpp_tpu_torch.tokenizer import load_tokenizer
    from embedding_cpp_tpu_torch.utils import jsonfmt
    from embedding_cpp_tpu_torch.utils.metrics import GLOBAL as metrics

    t_phase = time.perf_counter()
    opts = ComputeOptions(dtype="bfloat16", output_dtype="int8")
    engine = Engine.from_gguf(str(files["q4_0"]), opts=opts, device="cuda")
    second = Engine.from_gguf(str(files["f16"]), opts=opts, device="cuda")
    check(type(engine.tokenizer).__name__ == "NativeTokenizer",
          f"the served engine's tokenizer is {type(engine.tokenizer).__name__}")
    texts = synthetic_sentences(256, seed=41)
    want = engine.encode(texts)
    want_second = second.encode(texts[:16])
    # where a request's time goes: the engine's own call, and the float
    # rendering, both outside the server
    encode_ms = _best_s(lambda: engine.encode_with_counts(texts), 5) * 1e3
    tokenize_ms = _best_s(lambda: engine.tokenize_batch(texts), 5) * 1e3
    render_ms = _best_s(lambda: jsonfmt.embedding_data_json(want), 5) * 1e3
    corpus = synthetic_sentences(512, seed=43)
    http_port = _free_port()
    with _serving(engine, http_port=http_port, extra_engines={"minilm-f16": second},
                  model_name="minilm-l6-q4_0"):
        conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=300)
        replies, cos = {}, {}
        for fmt in ("float", "base64"):
            status, raw = _http(http_port, "POST", "/v1/embeddings",
                                {"input": texts, "encoding_format": fmt}, conn)
            check(status == 200, f"/v1/embeddings {fmt}: {status} {raw[:300]}")
            body = json.loads(raw)
            vecs = (_b64_vectors(body) if fmt == "base64"
                    else np.array([d["embedding"] for d in body["data"]], np.float32))
            replies[fmt] = len(raw)
            cos[fmt] = _min_cos(vecs, want)
            check(body["model"] == "minilm-l6-q4_0" and vecs.shape == want.shape,
                  f"{fmt}: {body['model']} {vecs.shape}")
        payloads = {fmt: {"input": texts, "encoding_format": fmt}
                    for fmt in ("float", "base64")}

        def post(fmt):
            status, _ = _http(http_port, "POST", "/v1/embeddings", payloads[fmt], conn)
            check(status == 200, f"/v1/embeddings {fmt}: {status}")

        windows = {fmt: [] for fmt in payloads}
        n_requests = 0
        timers0 = metrics.snapshot()
        reset_counts(counters)
        for _ in range(HTTP_REPEATS):
            for fmt in payloads:
                n, t0 = 0, time.perf_counter()
                while (dt := time.perf_counter() - t0) < HTTP_WINDOW_S:
                    post(fmt)
                    n += 1
                windows[fmt].append(n / dt)
                n_requests += n
        torch.cuda.synchronize()
        counts = read_counts(counters)
        timers1 = metrics.snapshot()
        rates = {fmt: statistics.median(w) for fmt, w in windows.items()}
        eval_n = timers1["timer_counts"]["eval"] - timers0["timer_counts"].get("eval", 0)
        eval_ms = 1e3 * (timers1["timers_s"]["eval"]
                         - timers0["timers_s"].get("eval", 0.0)) / max(eval_n, 1)
        # where a request's time goes on the card: kernels against wall
        # time, of the engine's call on this thread (the same forward a
        # request runs) and of requests served on the server's threads
        _, rows, table = _profiled(lambda: engine.encode_with_counts(texts))
        _save(out_dir, "profile_http_engine_call.txt", table)
        engine_busy_ms = sum(r[1] for r in rows) / 1e3
        profiled = {}
        for fmt in payloads:
            wall_ms, rows, table = _profiled(lambda: [post(fmt) for _ in range(HTTP_PROFILED)])
            _save(out_dir, f"profile_http_embeddings_{fmt}.txt", table)
            busy_ms = sum(r[1] for r in rows) / 1e3 / HTTP_PROFILED
            profiled[fmt] = {"requests": HTTP_PROFILED,
                             "wall_ms_under_profiler": wall_ms / HTTP_PROFILED,
                             "device_busy_ms": busy_ms if rows else None,
                             "device_share_of_request": (busy_ms if rows else engine_busy_ms)
                             * rates[fmt] / 1e3,
                             "kernels_seen": len(rows),
                             "top": [{"name": k[:60], "device_ms": us / 1e3 / HTTP_PROFILED}
                                     for k, us, _ in rows[:5]]}
        status, raw = _http(http_port, "POST", "/v1/tokenize", {"input": texts[:32]}, conn)
        tok = json.loads(raw)
        tokenize_ok = status == 200 and tok["ids"] == engine.tokenize_batch(texts[:32])
        status, raw = _http(http_port, "POST", "/v1/index", {"input": corpus}, conn)
        check(status == 200 and json.loads(raw)["total"] == len(corpus), f"/v1/index {raw}")
        status, raw = _http(http_port, "POST", "/v1/search", {"input": corpus[:64], "k": 5},
                            conn)
        hits = json.loads(raw)["results"]
        self_hits = sum(row[0]["index"] == i for i, row in enumerate(hits))
        status_m, raw_m = _http(http_port, "GET", "/metrics", None, conn)
        snap = json.loads(raw_m)
        status, raw = _http(http_port, "POST", "/v1/embeddings",
                            {"input": texts[:16], "model": "minilm-f16",
                             "encoding_format": "base64"}, conn)
        second_cos = _min_cos(_b64_vectors(json.loads(raw)), want_second)
        conn.close()
    # ingest: the native tokenizer (this engine) against the Python engine
    py_engine = Engine(engine.params, engine.config,
                       load_tokenizer(engine.tokenizer._blob, "python"), engine.special_ids,
                       opts=opts, device="cuda")
    docs = synthetic_sentences(2758, seed=0)
    ingest = {name: len(docs) / _best_s(lambda: _filled(VectorIndex(eng), docs), 2)
              for name, eng in (("native", engine), ("python", py_engine))}
    k1 = counts["q4_matmul"] / n_requests
    k2 = counts["attn_bse_packed"] / n_requests
    k3 = counts["attn_bse_keybias"] / n_requests
    out = {"phase": "http", "model": "minilm-l6-q4_0 (the formats phase's Q4_0 GGUF)",
           "texts_per_request": len(texts), "requests_timed": n_requests,
           "window_s": HTTP_WINDOW_S, "windows": windows,
           "requests_per_sec": rates,
           "request_ms": {k: 1e3 / v for k, v in rates.items()},
           "server_eval_ms_per_request": eval_ms, "server_evals": eval_n,
           "engine_encode_ms": encode_ms, "tokenize_ms": tokenize_ms,
           "float_render_ms": render_ms, "engine_call_device_busy_ms": engine_busy_ms,
           "profiled": profiled,
           "sentences_per_sec": {k: v * len(texts) for k, v in rates.items()},
           "response_bytes": replies, "min_cosine_vs_encode": cos,
           "threshold": COSINE_SERVER, "launches": counts,
           "launches_per_request": {"q4_matmul (K1)": k1, "attn_bse_packed (K2)": k2,
                                    "attn_bse_keybias (K3)": k3},
           "tokenize_ids_equal": tokenize_ok, "search_self_hits": f"{self_hits}/64",
           "metrics_requests": snap["server"]["requests"],
           "second_model_min_cosine": second_cos,
           "ingest_documents_per_sec": {**ingest,
                                        "vector_index_phase": index_docs_per_sec},
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    check(min(cos.values()) >= COSINE_SERVER, f"HTTP replies vs encode {cos}")
    check(second_cos >= COSINE_SERVER, f"second model route {second_cos}")
    check(tokenize_ok, "/v1/tokenize ids differ from engine.tokenize_batch")
    check(self_hits == 64, f"/v1/search self hits {self_hits}/64")
    check(status_m == 200 and "minilm-f16" in snap["models"], "/metrics")
    attn = counts["attn_bse_packed"] + counts["attn_bse_keybias"]
    check(counts["q4_matmul"] == 6 * attn and counts["attn_bse_packed"] > 0
          and counts["q4_matmul_2d"] == 0, f"HTTP launches {counts}")
    return out


def phase_cli(files: dict) -> dict:
    """`python -m embedding_cpp_tpu_torch.cli.main` as its own process on
    the card, on the formats phase's Q4_0 GGUF: its ids and tokens equal
    engine.tokenize's, its embedding head engine.encode's (f32, the CLI's
    default) to the 6 decimals it prints."""
    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.cli.engine_io import format_embedding
    from embedding_cpp_tpu_torch.models import ComputeOptions

    text = "the quick brown fox jumps over the lazy dog, partly cloudy outside"
    t_phase = t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "embedding_cpp_tpu_torch.cli.main", "-m", str(files["q4_0"]),
         "-p", text], cwd=str(ROOT), capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli.main failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.splitlines()
    engine = Engine.from_gguf(str(files["q4_0"]), device="cuda",
                              opts=ComputeOptions(dtype="float32"))
    ids = engine.tokenize(text)
    vec = engine.encode([text], prompt="")[0]
    head = next(line for line in lines if line.startswith("embedding["))
    printed = np.array([float(x) for x in head.split("[", 2)[2].split(",")[:8]])
    err = float(np.abs(printed - vec[:8]).max())
    out = {"phase": "cli", "wall_s": wall, "printed": head,
           "same_text_as_engine": head == format_embedding(vec),
           "max_abs_diff_vs_engine": err,
           "eval_lines": [line for line in lines if line.startswith(("load", "eval"))],
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    check(f"ids: {ids}" in lines, "cli ids differ from engine.tokenize")
    check(f"tokens: {[engine.id_to_token(i) for i in ids]}" in lines, "cli tokens differ")
    check(err <= 1e-6, f"cli embedding head differs from engine.encode by {err}")
    return out


def _k1_case(peaks, k: int, n: int, act, bias: bool, out_f32: bool, seed: int,
             what: str) -> dict:
    """K1 at one tp shard's linear, M = 16384 tokens, bf16 x, Q4_0: a
    column-parallel q/k/v/up (bias and activation in the epilogue) or a
    row-parallel o/down (`out_f32`, no bias: the partial product the tp
    slots sum), against its plain version, timed beside `mm` and the bound."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.ops.q4_matmul import dequant_weight, q4_matmul, q4_matmul_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    w = _q4_weight("Q4_0", k, n, seed)
    x = torch.randn(M_TOKENS, k, generator=gen).to(dev, torch.bfloat16)
    b = (torch.randn(n, generator=gen) * 0.1).to(dev) if bias else None
    before = (q4_matmul.launches, q4_matmul.n_tiled_launches)
    got = q4_matmul(x, w, bias=b, activation=act, out_f32=out_f32)
    check((q4_matmul.launches, q4_matmul.n_tiled_launches) == (before[0] + 1, before[1]),
          f"{what}: K1's route")
    ref = q4_matmul_plain(x, w, b, act, out_f32=out_f32)
    torch.cuda.synchronize()
    err, rel = _rel_err(got, ref)
    ok = rel <= BF16_REL and bool(torch.isfinite(got).all())
    check(got.dtype == (torch.float32 if out_f32 else torch.bfloat16), f"{what}: {got.dtype}")
    wd = dequant_weight(w, torch.bfloat16)

    def lib():
        y = torch.mm(x, wd, out_dtype=torch.float32) if out_f32 else (
            torch.mm(x, wd) if b is None else torch.addmm(b.to(torch.bfloat16), x, wd))
        return F.gelu(y) if act == "gelu_erf" else y

    nbytes = (x.numel() * 2 + w.qs.numel() + w.scales.numel() * 4 + (n * 4 if bias else 0)
              + M_TOKENS * n * (4 if out_f32 else 2))
    case = {"shape": what, "m": M_TOKENS, "k": k, "n": n, "act": act, "out_f32": out_f32,
            "qtype": "Q4_0", "dtype": "bfloat16", "tile": _k1_tile(M_TOKENS, k, n, False),
            "max_abs_err": err, "rel_err": rel, "tolerance": _tolerance(torch.bfloat16),
            "ok": ok,
            "ms": gpu_ms(lambda: q4_matmul(x, w, bias=b, activation=act, out_f32=out_f32)),
            "plain_ms": gpu_ms(lambda: q4_matmul_plain(x, w, b, act, out_f32=out_f32),
                               samples=5, reps=1),
            "library_ms": gpu_ms(lib)}
    case["bound_ms"], case["bound_by"] = bound_ms(nbytes, 2.0 * M_TOKENS * k * n, peaks)
    emit({"phase": "kernel_check", "kernel": "q4_matmul", "model": "minilm-l6/mesh", **case})
    check(ok, f"q4_matmul {what}: err {err} rel {rel}")
    return case


def phase_kernels_mesh(peaks) -> dict:
    """The kernels at the shapes a tp shard gives them: K1 at MiniLM-L6's
    linears at tp = 2 and 4 (q 384 -> 192 / 96 with bias, up 384 -> 768 /
    384 + gelu, o and down row-parallel with `out_f32`: K = 192 and 96 for
    o, one and a half of the bf16 body's 64-deep K steps at 96; K = 768 and
    384 for down), K2/K3 at 6 and 3 heads of 32 ([32, 512] packed and key
    padded), K4 at MPNet's tp = 2 shard: 6 heads of 64 with a [6, S, S]
    bias, plain and packed.  Each against its plain version, timed."""
    import torch
    import torch.nn.functional as F

    from embedding_cpp_tpu_torch.ops.attention import (
        MASK_BIAS,
        attention_bse_plain,
        flash_attention_bse,
        flash_attention_packed_bse,
    )

    out = {"k1": {}}
    for tp in (2, 4):
        for name, k, n, act, bias, f32 in (("q", 384, 384 // tp, None, True, False),
                                           ("up", 384, 1536 // tp, "gelu_erf", True, False),
                                           ("o", 384 // tp, 384, None, False, True),
                                           ("down", 1536 // tp, 384, None, False, True)):
            out["k1"][f"{name}/tp{tp}"] = _k1_case(peaks, k, n, act, bias, f32, seed=k * n + tp,
                                                   what=f"{name} {k}->{n} at tp={tp}")
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(11)
    rng = np.random.default_rng(11)
    seg_np = serving_segments(rng, 32, 512)[0]
    seg = torch.from_numpy(seg_np).to(dev)
    pairs = segment_pairs(seg_np)
    lens = rng.integers(1, 513, size=32)
    keyb = torch.where(torch.arange(512)[None, :] < torch.from_numpy(lens)[:, None], 0.0,
                       MASK_BIAS).to(torch.float32).to(dev)
    bias6 = (torch.randn(6, 512, 512, generator=gen) * 0.5).to(dev)
    for kname, h, d, pbias in (("attn_bse_packed", 6, 32, None), ("attn_bse_packed", 3, 32, None),
                               ("attn_bse_keybias", 6, 32, None),
                               ("attn_bse_keybias", 3, 32, None),
                               ("attn_bse_bias", 6, 64, bias6),
                               ("attn_bse_bias_packed", 6, 64, bias6)):
        packed = kname.endswith("packed")
        mask = seg if packed else keyb
        fn = flash_attention_packed_bse if packed else flash_attention_bse
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(32, 512, h * d, generator=gen).to(dev, dtype)
                       for _ in range(3))
            heads = [_bse_heads(t, h) for t in (q, k, v)]
            lmask = ((seg[:, :, None] == seg[:, None, :])[:, None] if packed
                     else keyb.to(dtype)[:, None, None, :])
            if pbias is not None:
                lmask = (torch.where(lmask, 0.0, MASK_BIAS) if packed else lmask.float()) \
                    + pbias[None]
                lmask = lmask.to(dtype)
            nbytes = (4 * q.numel() * q.element_size() + mask.numel() * 4
                      + (pbias.numel() * 4 if pbias is not None else 0))
            flops = 4.0 * h * d * pairs if packed else 4.0 * 32 * h * 512 * 512 * d
            c = _attention_case(
                kname, lambda *a, fn=fn, h=h, pb=pbias: fn(*a, h, pb),
                lambda *a, h=h, packed=packed, pb=pbias: attention_bse_plain(*a, h, packed, pb),
                lambda: F.scaled_dot_product_attention(*heads, attn_mask=lmask),
                (q, k, v, mask), nbytes, flops, peaks, dtype == torch.bfloat16,
                model="mesh", b=32, s=512, h=h, d=d)
            if dtype == torch.bfloat16:
                out[f"{kname}/h{h}"] = c
    return out


def phase_mesh(counters, main: dict, token_lists, mpnet) -> dict:
    """MiniLM-L6 (the main phase's weights, Q4_0, bf16) on meshes of slots
    on the one card: dp 2 x tp 2 and dp 1 x tp 4, the corpus packed ("auto")
    and in plain buckets ("never"): every slot's K1/K2/K3 launches, the
    outputs against the single-device engine's by cosine (the main phase's
    bf16 bar) and, with f32 activations on 256 sentences, within 2e-5;
    sentences/s beside the single-device engine's in this call (the slots
    of one card run one after another: no gain is claimed).  MPNet at tp 2:
    K4 with each slot's [6, S, S] slice of the relative bias, against the
    single-device MPNet engine.  Returns the launches."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions
    from embedding_cpp_tpu_torch.parallel.mesh import make_mesh

    config, base = main["config"], main["base"]
    cards = ["cuda:0"] * 4
    meshes = {"dp2xtp2": make_mesh(dp=2, tp=2, devices=cards),
              "dp1xtp4": make_mesh(dp=1, tp=4, devices=cards)}
    bf16 = ComputeOptions(dtype="bfloat16")
    total = {k: 0 for k in counters}
    result = {"phase": "mesh", "model": config.name, "devices": "4 slots on cuda:0",
              "cosine_threshold": COSINE_VS_CPU, "f32_atol": 2e-5}
    rates = {"single/" + p: len(token_lists) / _best_s(
        lambda e=main["engines"][(p, "float32")]: e.embed_tokens(token_lists), 3)
        for p in ("auto", "never")}
    for tag, mesh in meshes.items():
        slots = mesh.dp * mesh.tp
        for packing in ("auto", "never"):
            eng = Engine(base.params, config, base.tokenizer, base.special_ids, opts=bf16,
                         packing=packing, mesh=mesh)
            out, counts = _counted(counters, lambda e=eng: e.embed_tokens(token_lists))
            forwards = _expected_forwards(eng, token_lists)
            attn = counts["attn_bse_packed"] + counts["attn_bse_keybias"]
            emit({"phase": "mesh_launches", "mesh": tag, "packing": packing,
                  "forwards": forwards, "slots": slots, "launches": counts})
            check(counts["q4_matmul"] == 36 * forwards * slots
                  and counts["q4_matmul_2d"] == 0 and counts["q4_matmul_ln"] == 0,
                  f"mesh {tag} {packing}: K1 {counts}")
            check(attn == 6 * forwards * slots
                  and sum(counts[k] for k in ATTENTION) == attn, f"mesh {tag} {packing}: {counts}")
            check(counts["attn_bse_packed" if packing == "auto" else "attn_bse_keybias"] > 0,
                  f"mesh {tag} {packing}: {counts}")
            for k in total:
                total[k] += counts[k]
            single = main["outs"][(packing, "float32")]
            check(np.isfinite(out).all() and out.shape == single.shape, f"mesh {tag}: output")
            result[f"min_cosine/{tag}/{packing}"] = _min_cos(out, single)
            check(result[f"min_cosine/{tag}/{packing}"] >= COSINE_VS_CPU,
                  f"mesh {tag} {packing}: cosine {result[f'min_cosine/{tag}/{packing}']}")
            rates[f"{tag}/{packing}"] = len(token_lists) / _best_s(
                lambda e=eng: e.embed_tokens(token_lists), 3)
            result[f"forwards/{tag}/{packing}"] = forwards
        # f32 activations: the sharded sums against one device's, 256 sentences
        f32 = ComputeOptions(dtype="float32")
        one = Engine(base.params, config, base.tokenizer, base.special_ids, opts=f32,
                     device="cuda").embed_tokens(token_lists[:256])
        sharded, counts = _counted(counters, lambda: Engine(
            base.params, config, base.tokenizer, base.special_ids, opts=f32,
            mesh=mesh).embed_tokens(token_lists[:256]))
        for k in total:
            total[k] += counts[k]
        result[f"f32_max_abs_err/{tag}"] = float(np.abs(sharded - one).max())
        check(result[f"f32_max_abs_err/{tag}"] <= 2e-5,
              f"mesh {tag} f32: {result[f'f32_max_abs_err/{tag}']}")
    # MPNet at tp 2: K4 with each slot's slice of the [12, S, S] bias
    mp_mesh = make_mesh(dp=1, tp=2, devices=["cuda:0"] * 2)
    mp_lists = token_lists[:256]
    mp_total = {k: 0 for k in counters}
    for packing in ("auto", "never"):
        one = Engine(mpnet.params, mpnet.config, mpnet.tokenizer, mpnet.special_ids,
                     opts=bf16, device="cuda", packing=packing).embed_tokens(mp_lists)
        eng = Engine(mpnet.params, mpnet.config, mpnet.tokenizer, mpnet.special_ids,
                     opts=bf16, packing=packing, mesh=mp_mesh)
        out, counts = _counted(counters, lambda e=eng: e.embed_tokens(mp_lists))
        forwards = _expected_forwards(eng, mp_lists)
        kname = "attn_bse_bias_packed" if packing == "auto" else "attn_bse_bias"
        check(counts[kname] == 12 * forwards * 2 and counts["q4_matmul"] == 72 * forwards * 2,
              f"mesh mpnet {packing}: {counts}")
        for k in mp_total:
            mp_total[k] += counts[k]
        result[f"min_cosine/mpnet-tp2/{packing}"] = _min_cos(out, one)
        check(result[f"min_cosine/mpnet-tp2/{packing}"] >= COSINE_VS_CPU,
              f"mesh mpnet {packing}: cosine {result[f'min_cosine/mpnet-tp2/{packing}']}")
    result["sentences_per_sec"] = rates
    result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    emit(result)
    return {"minilm": total, "mpnet": mp_total}


def _server_proc(model: Path, port: int, http_port: int, extra: list, log_path: Path):
    log = open(log_path, "w")
    return subprocess.Popen(
        [sys.executable, "-m", "embedding_cpp_tpu_torch.runtime.server", "-m", str(model),
         "--host", "127.0.0.1", "--port", str(port), "--http-port", str(http_port),
         "--output-dtype", "float32", *extra],
        cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT)


def phase_distributed(files: dict, texts: list[str]) -> dict:
    """The server as two processes sharing cuda:0 (`--device cuda:0` on
    both: without it each process would take a card of its own) through its
    own --coordinator / --num-processes / --process-id (a mesh of dp 2, one
    row a process; the data plane must be gloo: NCCL refuses two ranks on
    one card): 64 TPE2 frames of 32 corpus texts and one /v1/embeddings
    request, each against the single-device engine's encode of the same
    texts (cosine >= COSINE_SERVER); SIGTERM to the leader must release the
    follower, and both must exit 0."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.models import ComputeOptions

    root = Path(files["tmp"].name)
    model = files["q4_0"]
    one = Engine.from_gguf(str(model), opts=ComputeOptions(dtype="bfloat16"), device="cuda")
    port, http_port, coord = _free_port(), _free_port(), _free_port()
    t0 = time.perf_counter()
    procs = [_server_proc(model, port, http_port,
                          ["--device", "cuda:0", "--coordinator", f"127.0.0.1:{coord}",
                           "--num-processes", "2", "--process-id", str(pid)],
                          root / f"dist{pid}.log")
             for pid in (0, 1)]
    logs = lambda: [(root / f"dist{pid}.log").read_text()[-3000:] for pid in (0, 1)]  # noqa: E731
    try:
        s = None
        while s is None:
            check(all(p.poll() is None for p in procs), f"a server process exited: {logs()}")
            check(time.perf_counter() - t0 < 300, "the 2-process server did not listen in 300 s")
            try:
                s = socket.create_connection(("127.0.0.1", port), 1.0)
            except OSError:
                time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        worst, frames = 1.0, 64
        with s:
            s.settimeout(120)
            (n_embd,) = struct.unpack("<i", _recv(s, 4))
            t1 = time.perf_counter()
            for i in range(frames):
                batch = texts[32 * i: 32 * (i + 1)]
                body = b"".join(struct.pack("<I", len(t.encode())) + t.encode() for t in batch)
                s.sendall(b"TPE2" + struct.pack("<I", len(batch)) + body)
                (count,) = struct.unpack("<I", _recv(s, 4))
                vecs = np.frombuffer(_recv(s, 4 * count * n_embd), np.float32).reshape(count, -1)
                worst = min(worst, _min_cos(vecs, one.encode(batch)))
            frames_s = time.perf_counter() - t1
        status, body_out = _http(http_port, "POST", "/v1/embeddings", {"input": texts[:64]})
        check(status == 200, f"distributed HTTP: {status} {body_out[:300]}")
        http_vecs = np.array([d["embedding"] for d in json.loads(body_out)["data"]], np.float32)
        http_cos = _min_cos(http_vecs, one.encode(texts[:64]))
        procs[0].terminate()
        rcs = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = logs()
    backend = "gloo" if "data plane gloo" in text[0] else ("nccl" if "data plane nccl" in
                                                           text[0] else None)
    result = {"phase": "distributed", "model": "minilm-l6 (the formats phase's Q4_0 file)",
              "processes": 2, "device": torch.cuda.get_device_name(0), "backend": backend,
              "seconds_to_listen": ready_s, "tpe2_frames": frames, "texts_per_frame": 32,
              "tpe2_seconds": frames_s, "min_cosine_tpe2": worst, "min_cosine_http": http_cos,
              "threshold": COSINE_SERVER, "exit_codes": rcs,
              "follower_ready": "follower process 1 of 2 ready" in text[1]}
    emit(result)
    check(backend == "gloo", f"distributed: data plane {backend}: {text[0][-500:]}")
    check(worst >= COSINE_SERVER and http_cos >= COSINE_SERVER, f"distributed replies: {result}")
    check(rcs == [0, 0] and result["follower_ready"], f"distributed exits {rcs}: {text}")
    return result


# --- the user-level scripts (benchmarks/: eval, headline, serving, ...) ------

EVAL_MODES = ("f32", "f16", "q4_0", "q4_1", "q8_0")
# the card's f32 eval against the CPU's f32 run: Spearman and nDCG@10 within
# 1e-3; accuracy within 0.01, since one of the 128 test texts moves it 0.0078
EVAL_F32_BAR, EVAL_ACCURACY_BAR = 1e-3, 0.01


def start_eval_reference(out_dir: Path) -> subprocess.Popen:
    """The eval phase's reference, `run_eval --synthetic --preset
    minilm-l6` on the CPU at f32 in every engine mode, in its own process
    (no card visible to it); its JSON line goes to out_dir/reference.json."""
    import os

    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    cmd = [sys.executable, "-m", "embedding_cpp_tpu_torch.benchmarks.run_eval", "--synthetic",
           "--preset", "minilm-l6", "--device", "cpu", "--dtype", "float32",
           "--modes", *EVAL_MODES, "--results", str(out_dir / "cpu")]
    return subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=open(out_dir / "reference.json",
                                                                      "w"),
                            stderr=open(out_dir / "reference.log", "w"))


def _score_gaps(got: dict, ref: dict, bar: float, acc_bar: float) -> list[str]:
    """Every score of `got` ({mode: {task: score}}) farther than its bar
    from `ref`'s, and every score `ref` has that `got` lacks."""
    gaps = []
    for mode, scores in ref.items():
        for task, want in scores.items():
            have = got.get(mode, {}).get(task)
            lim = acc_bar if task == "EmotionClassification" else bar
            if have is None or abs(have - want) > lim:
                gaps.append(f"{mode}/{task}: {have} vs {want} (bar {lim})")
    return gaps


def phase_eval(counters, reference: subprocess.Popen, out_dir: Path) -> dict:
    """`run_eval --synthetic --preset minilm-l6` on the card at f32 and at
    the default bf16, in every engine mode, against the CPU's f32 run."""
    import torch

    from embedding_cpp_tpu_torch.benchmarks import run_eval

    check(reference.wait(timeout=900) == 0, f"eval reference exited {reference.returncode}: "
          f"{(out_dir / 'reference.log').read_text()[-2000:]}")
    cpu = json.loads((out_dir / "reference.json").read_text().strip().splitlines()[-1])
    card, counts, seconds = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        reset_counts(counters)
        t0 = time.perf_counter()
        card[dtype] = run_eval.main(["--synthetic", "--preset", "minilm-l6", "--device", "cuda",
                                     "--dtype", dtype, "--modes", *EVAL_MODES,
                                     "--results", str(out_dir / dtype)])
        torch.cuda.synchronize()
        seconds[dtype] = time.perf_counter() - t0
        counts[dtype] = read_counts(counters)
    gaps = {"float32": _score_gaps(card["float32"]["scores"], cpu["scores"], EVAL_F32_BAR,
                                   EVAL_ACCURACY_BAR),
            "bfloat16": _score_gaps(card["bfloat16"]["scores"], cpu["scores"],
                                    run_eval.SCORE_TOLERANCE, run_eval.SCORE_TOLERANCE)}
    total = {k: counts["float32"][k] + counts["bfloat16"][k] for k in counters}
    result = {"phase": "eval", "model": "minilm-l6 (synthetic, make_test_model)",
              "modes": EVAL_MODES, "cpu_f32": cpu["scores"],
              "card_f32": card["float32"]["scores"], "card_bf16": card["bfloat16"]["scores"],
              "card_seconds": seconds,
              "bars": {"float32": [EVAL_F32_BAR, EVAL_ACCURACY_BAR],
                       "bfloat16": run_eval.SCORE_TOLERANCE},
              "gaps": gaps, "gate_failures": {d: card[d]["failures"] for d in card},
              "launches": {"float32": counts["float32"], "bfloat16": counts["bfloat16"]}}
    emit(result)
    check(cpu["failures"] == [], f"eval reference gates: {cpu['failures']}")
    check(not gaps["float32"] and not gaps["bfloat16"], f"eval scores, card vs CPU: {gaps}")
    check(all(card[d]["device"] != "cpu" for d in card), "the card's eval ran on the CPU")
    check(min(total[k] for k in ("q4_matmul", "attn_bse_packed", "attn_bse_keybias")) > 0,
          f"eval launches {total}")
    return total


def phase_headline(counters, main: dict) -> dict:
    """benchmarks/bench.py's run_headline and run_ab_transfer on the card:
    the in-device [32, 512] forwards against the main phase's (the same
    weights, inputs and timer), its rate beside the main phase's."""
    import torch

    from embedding_cpp_tpu_torch.benchmarks import bench

    reset_counts(counters)
    head = bench.run_headline(device="cuda")
    ab = bench.run_ab_transfer(device="cuda")
    torch.cuda.synchronize()
    counts = read_counts(counters)
    fwd = {"plain": head["forward_ms_in_device_b32_s512"],
           "packed": head["packed_forward_ms_in_device_b32_s512"]}
    vs_main = {k: fwd[k] / main["forward_ms"][k] - 1.0 for k in fwd}
    result = {"phase": "headline", "headline": head, "ab_transfer": ab,
              "main_forward_ms": main["forward_ms"], "forward_vs_main": vs_main,
              "rate_vs_main_int8": head["value"] / main["sentences_per_sec"]["auto/int8"],
              "rate_vs_main_f32": (head["f32_sentences_per_sec"]
                                   / main["sentences_per_sec"]["auto/float32"]),
              "launches": counts}
    emit(result)
    check(head["int8_cosine_vs_f32_min"] >= COSINE_INT8, f"headline int8 cosine {head}")
    check(max(abs(v) for v in vs_main.values()) <= 0.02,
          f"headline forward vs the main phase's: {vs_main}")
    check(min(counts[k] for k in ("q4_matmul", "attn_bse_packed", "attn_bse_keybias")) > 0,
          f"headline launches {counts}")
    return counts


def phase_serving(counters) -> dict:
    """benchmarks/serving.py on the card: 4 clients of 2048 texts in
    requests of 64 over TCP (f32 and int8 wire) and HTTP (base64), and the
    serving-tax A/B; each run's replies against Engine.encode."""
    import torch

    from embedding_cpp_tpu_torch.benchmarks import serving

    runs = {}
    reset_counts(counters)
    for tag, argv in (("tcp_f32", []), ("tcp_int8", ["--wire", "int8"]),
                      ("http_base64", ["--protocol", "http", "--http-encoding", "base64"]),
                      ("overhead_ab", ["--overhead-ab"])):
        runs[tag] = serving.main(["--device", "cuda", *argv])
    torch.cuda.synchronize()
    counts = read_counts(counters)
    result = {"phase": "serving", "runs": runs, "launches": counts}
    emit(result)
    for tag, r in runs.items():
        bar = COSINE_INT8 if tag == "tcp_int8" else COSINE_SERVER
        check(r["min_cosine_vs_encode"] >= bar, f"serving {tag} replies: {r}")
    check(counts["q4_matmul"] > 0 and counts["attn_bse_packed"] > 0,
          f"serving launches {counts}")
    return counts


def phase_scaling(counters) -> dict:
    """benchmarks/scaling.py on dp 1, 2 and 4 slots of the one card."""
    import torch

    from embedding_cpp_tpu_torch.benchmarks import scaling

    reset_counts(counters)
    out = scaling.main(["--device", "cuda:0", "--dp", "1", "2", "4"])
    torch.cuda.synchronize()
    counts = read_counts(counters)
    emit({"phase": "scaling", "result": out, "launches": counts})
    check(set(out["results"]) == {1, 2, 4} and counts["q4_matmul"] > 0
          and counts["attn_bse_keybias"] > 0, f"scaling {out} {counts}")
    return counts


def phase_retrieval_scripts(counters) -> dict:
    """benchmarks/search.py, sparse.py and maxsim_bench.py on the card at
    their default sizes (sparse.py --search at 100,000 documents)."""
    import torch

    from embedding_cpp_tpu_torch.benchmarks import maxsim_bench, search, sparse

    counts = {}
    runs = {}
    for tag, fn, argv in (("search", search.main, []), ("sparse", sparse.main, []),
                          ("sparse_search", sparse.main, ["--search", "--docs", "100000"]),
                          ("maxsim", maxsim_bench.main, [])):
        reset_counts(counters)
        runs[tag] = fn(["--device", "cuda", *argv])
        torch.cuda.synchronize()
        counts[tag] = read_counts(counters)
        torch.cuda.empty_cache()
    emit({"phase": "retrieval_scripts", "runs": runs, "launches": counts})
    check(runs["sparse_search"]["topk_agreement"] == 1.0, f"sparse search {runs}")
    check(counts["search"]["attn_bse_packed"] + counts["search"]["attn_bse_keybias"] > 0,
          f"search ingest launches {counts['search']}")
    check(counts["sparse"]["q4_matmul"] > 0 and counts["sparse"]["attn_bse_keybias"] > 0,
          f"sparse launches {counts['sparse']}")
    return counts


# --- head dims outside the kernels' instances, and the breakdown scripts ------

def plain_routes() -> dict:
    """Every attention wrapper's count of calls that "auto" sent to the
    plain version because no kernel instance serves their head dim (never
    reset: the run's total)."""
    from embedding_cpp_tpu_torch.ops import attention as A
    from embedding_cpp_tpu_torch.ops import deberta_attention as DA

    fns = (A.flash_attention_bse, A.flash_attention_packed_bse, A.flash_attention,
           A.flash_attention_local, A.flash_attention_packed, A.flash_attention_packed_local,
           DA.disentangled_attention, DA.disentangled_attention_packed)
    return {fn.__name__: fn.plain_routes for fn in fns}


def phase_head_dims(counters, token_lists) -> dict:
    """A 384-wide Q4_0 Engine of 4 heads of 96 (MiniLM-L6's shape
    otherwise) in bf16 over the corpus, packed (K2) and plain (K3), against
    the same weights with attn_impl "plain", and no plain route; then
    tiny-modernbert at 2 heads of 24, packed "always" at 2048, through the
    counted plain route, against the f32 CPU path."""
    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.cli.make_test_model import PRESETS
    from embedding_cpp_tpu_torch.models import MINILM_L6, ComputeOptions

    config = replace(MINILM_L6, n_vocab=1000, n_head=4, name="minilm-l6-4x96")
    base = Engine.synthetic(config, "q4_0", seed=21, opts=ComputeOptions(dtype="bfloat16"),
                            device="cuda")
    result = {"phase": "head_dims", "model": config.name, "head_dim": config.head_dim,
              "sentences": len(token_lists)}
    total = {k: 0 for k in counters}
    for packing in ("auto", "never"):
        eng, plain = (Engine(base.params, config, base.tokenizer, base.special_ids,
                             opts=ComputeOptions(dtype="bfloat16", attn_impl=impl),
                             device="cuda", packing=packing) for impl in ("auto", "plain"))
        routes = plain_routes()
        reset_counts(counters)
        got = eng.embed_tokens(token_lists)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        ref = plain.embed_tokens(token_lists)
        cos = _min_cos(got, ref)
        used = "attn_bse_packed" if packing == "auto" else "attn_bse_keybias"
        forwards = _expected_forwards(eng, token_lists)
        result[packing] = {"launches": counts, "forwards": forwards,
                           "min_cosine_vs_plain": cos}
        attn = counts["attn_bse_packed"] + counts["attn_bse_keybias"]
        check(counts[used] > 0 and attn == 6 * forwards
              and sum(counts[k] for k in ATTENTION) == attn
              and counts["q4_matmul"] == 36 * forwards,
              f"head_dims {packing}: launches {counts} over {forwards} forwards")
        check(plain_routes() == routes, f"head_dims {packing}: a plain route at d 96")
        check(cos >= COSINE_VS_CPU, f"head_dims {packing}: cosine vs plain {cos}")
        total = {k: total[k] + counts[k] for k in counters}

    tiny = replace(PRESETS["tiny-modernbert"], n_embd=48, n_head=2, n_ctx=2048)
    kw = dict(packing="always", pack_seq=2048)
    rng = np.random.default_rng(24)
    lists = [rng.integers(5, tiny.n_vocab, size=int(n)).tolist()
             for n in (12, 700, 1500, 64, 300, 900)]
    card = Engine.synthetic(tiny, "f32", device="cuda", **kw)
    routes = plain_routes()
    reset_counts(counters)
    got = card.embed_tokens(lists)
    torch.cuda.synchronize()
    counts = read_counts(counters)
    card_routes = {k: v - routes[k] for k, v in plain_routes().items()}
    # the CPU path's calls count too: the route is decided from the shape
    err = float(np.abs(got - Engine.synthetic(tiny, "f32", device="cpu", **kw)
                       .embed_tokens(lists)).max())
    taken = {k: v - routes[k] for k, v in plain_routes().items()}
    result["d24"] = {"model": "tiny-modernbert 48 wide, 2 heads of 24, packed always at 2048",
                     "lists": len(lists), "plain_routes_card": card_routes,
                     "plain_routes_card_and_cpu": taken, "max_abs_err_vs_cpu": err,
                     "attention_launches": sum(counts[k] for k in ATTENTION)}
    emit(result)
    check(card_routes["flash_attention_packed"] > 0
          and card_routes["flash_attention_packed_local"] > 0
          and 2 * card_routes["flash_attention_packed"] == taken["flash_attention_packed"],
          f"d 24: the plain routes {card_routes}, with the CPU path's {taken}")
    check(sum(counts[k] for k in ATTENTION) == 0, f"d 24 launched a kernel: {counts}")
    check(err <= 1e-4, f"d 24 vs the CPU path: {err}")
    return total, taken


def phase_scripts(counters, files: dict, out_dir) -> dict:
    """The breakdown and A/B scripts, the kernel suite's full-forward modes
    and the C ABI example on the card, each as a user runs it (its main):
    launches and seconds per script, and the checks each one's output
    allows."""
    import tempfile

    import torch

    from embedding_cpp_tpu_torch import Engine
    from embedding_cpp_tpu_torch.benchmarks import (
        attn_bias_smoke,
        forward_breakdown,
        modernbert_breakdown,
        packed_bse_ab,
    )
    from embedding_cpp_tpu_torch.benchmarks import kernels as suite
    from embedding_cpp_tpu_torch.examples import sample_dylib
    from embedding_cpp_tpu_torch.models import ComputeOptions

    results = str(out_dir / "bench_results") if out_dir is not None else ""
    cut = ["--device", "cuda", "--vocab", "1000", "--results", results]
    build = tempfile.TemporaryDirectory(prefix="chip_smoke_capi_")
    modes = [f"--{m.replace('_', '-')}" for m in suite.FORWARD_MODES]
    jobs = (("forward_breakdown", forward_breakdown.main, [*cut, "--samples", "10"]),
            ("modernbert_breakdown", modernbert_breakdown.main,
             [*cut, "--samples", "5", "--ab-samples", "3"]),
            ("packed_bse_ab", packed_bse_ab.main,
             [*cut, "--samples", "10", "--forward-samples", "3"]),
            ("attn_bias_smoke", attn_bias_smoke.main, ["--device", "cuda", "--results", results]),
            ("kernels_forward_modes", suite.main, [*cut, *modes, "--samples", "3"]),
            ("sample_dylib", sample_dylib.main,
             [str(files["q4_0"]), "--device", "cuda", "--demo", "--build-dir", build.name]))
    runs, counts, seconds = {}, {}, {}
    try:
        for tag, fn, argv in jobs:
            reset_counts(counters)
            t0 = time.perf_counter()
            runs[tag] = fn(argv)  # attn_bias_smoke exits 1 where a case misses
            torch.cuda.synchronize()
            seconds[tag] = time.perf_counter() - t0
            counts[tag] = read_counts(counters)
            torch.cuda.empty_cache()
    finally:
        build.cleanup()
    fb, mb, ab = runs["forward_breakdown"], runs["modernbert_breakdown"], runs["packed_bse_ab"]
    dyl = runs["sample_dylib"]
    ref = Engine.from_gguf(str(files["q4_0"]), opts=ComputeOptions(dtype="bfloat16"),
                           device="cuda").encode(sample_dylib.SENTENCES)
    dyl_cos = _min_cos(np.asarray(dyl["embeddings"], np.float32), ref)
    emit({"phase": "scripts", "seconds": seconds, "launches": counts,
          "forward_breakdown": {k: fb[k] for k in ("full_forward_us", "per_layer_us",
                                                   "accounted_us", "accounted_pct")},
          "modernbert_breakdown": {k: mb[k] for k in ("full_forward_us", "per_layer_us",
                                                      "accounted_us", "accounted_pct")},
          "packed_kernel": ab["packed_kernel_b32_s512_minilm_geom"],
          "attn_bias_smoke_ok": runs["attn_bias_smoke"]["ok"],
          "sample_dylib": {"n_embd": dyl["n_embd"], "min_cosine_vs_encode": dyl_cos,
                           "demo": dyl["demo"]}})
    check(runs["attn_bias_smoke"]["ok"], "attn_bias_smoke missed a case")
    check(0 < fb["accounted_pct"] and 0 < mb["accounted_pct"],
          f"breakdowns: {fb['accounted_pct']} {mb['accounted_pct']}")
    check(ab["packed_kernel_b32_s512_minilm_geom"]["bse_vs_plain"] <= 0.06,
          f"packed_bse_ab parity {ab['packed_kernel_b32_s512_minilm_geom']}")
    check(dyl["n_embd"] == 384 and dyl_cos >= COSINE_SERVER and "search" in dyl["demo"],
          f"sample_dylib: cosine {dyl_cos}, demo {dyl['demo']!r}")
    for r in (fb, mb, ab, runs["attn_bias_smoke"], runs["kernels_forward_modes"], dyl):
        check(isinstance(r["device"], dict) and "power_limit" in r["device"],
              f"a script's device entry: {r['device']}")
    total = {k: sum(c[k] for c in counts.values()) for k in counters}
    launched = ("q4_matmul", "attn_bse_packed", "attn_bse_keybias", "attn_bse_bias",
                "attn_long", "attn_seg", "attn_local", "deberta_attn")
    check(all(total[k] > 0 for k in launched), f"the scripts' launches {total}")
    return total


def _entry(name: str, source: str, replaces: str, launches: int, c: dict, shape: str,
           **extra) -> dict:
    return {"name": name, "route": "cuda", "source": f"embedding_cpp_tpu_torch/csrc/{source}",
            "replaces": f"embedding_cpp_tpu/ops/{replaces}", "launches": launches,
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "shape": shape, **extra}


def _timing(c: dict) -> dict:
    return {k: c[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}


def launch_counters() -> dict:
    """Every kernel wrapper's launch counter, by the name the kernels line
    gives it."""
    from embedding_cpp_tpu_torch.ops import attention as A
    from embedding_cpp_tpu_torch.ops import deberta_attention as DA
    from embedding_cpp_tpu_torch.ops.q4_matmul import q4_matmul

    return {"q4_matmul": (q4_matmul, "launches"),
            "q4_matmul_prologue": (q4_matmul, "prologue_launches"),
            "q4_matmul_2d": (q4_matmul, "n_tiled_launches"),
            "q4_matmul_ln": (q4_matmul, "ln_launches"),
            "attn_bse_packed": (A.flash_attention_packed_bse, "launches"),
            "attn_bse_keybias": (A.flash_attention_bse, "launches"),
            "attn_bse_bias": (A.flash_attention_bse, "bias_launches"),
            "attn_bse_bias_packed": (A.flash_attention_packed_bse, "bias_launches"),
            "attn_long": (A.flash_attention, "launches"),
            "attn_local": (A.flash_attention_local, "launches"),
            "deberta_attn": (DA.disentangled_attention, "launches"),
            "deberta_attn_packed": (DA.disentangled_attention_packed, "launches"),
            "attn_seg": (A.flash_attention_packed, "launches"),
            "attn_seg_window": (A.flash_attention_packed, "window_launches"),
            "attn_seg_local": (A.flash_attention_packed_local, "launches"),
            "attention_headpack": (A.attention_headpack, "launches")}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", type=Path, default=None,
                   help="write the ptxas log and profiler tables here")
    out_dir = p.parse_args().out_dir
    sys.path.insert(0, str(ROOT))
    name, smi, peaks = phase_device()
    import tempfile

    import torch

    # the eval phase's CPU reference runs in its own process from here on
    scripts_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_scripts_")
    eval_dir = Path(scripts_tmp.name) / "eval"
    eval_reference = start_eval_reference(eval_dir)

    from embedding_cpp_tpu_torch.models import (
        ALBERT_BASE,
        GTR_BASE,
        MPNET_BASE,
        MULTI_QA_DISTILBERT,
        MULTILINGUAL_E5_BASE,
    )
    # the host libraries compile while nvcc builds the kernels
    native = {}
    native_thread = threading.Thread(target=lambda: native.update(
        _caught(phase_native_build)))
    native_thread.start()
    phase_build(out_dir)
    native_thread.join()
    check("error" not in native, f"native build failed: {native.get('error')}")
    emit(native["result"])
    k1 = phase_kernels_q4(peaks, "minilm-l6", ("qkvo", "up", "down"), seed=0)
    k1m = phase_kernels_q4(peaks, "modernbert-base", ("down",), seed=2)
    k1d = phase_kernels_q4(peaks, "deberta-v3-base", ("down",), seed=3)
    k1n = phase_kernels_q4(peaks, "nomic-embed-text-v1.5", ("down",), seed=4)
    k1b = phase_kernels_q4(peaks, "bge-large-en-v1.5", ("qkvo",), seed=5)
    k1es = phase_kernels_q4(peaks, "electra-small", (), seed=6)
    k1t5 = phase_kernels_q4(peaks, "gtr-t5-base", (), seed=7)
    k1t5g = phase_kernels_q4(peaks, "t5-v1.1-base", ("down",), seed=8)
    k1t = phase_kernels_k1_tiles(peaks)
    k8 = phase_kernels_k8(peaks, F32_PEAKS[peaks_for(name)[0]])
    k1ln = phase_kernels_ln(peaks)
    attn = phase_kernels_attention(peaks, "minilm-l6", 12, 32, seed=0)
    # ModernBERT's global layers and nomic share this shape: [32, 512, 12x64]
    attn_mb = phase_kernels_attention(peaks, "modernbert-base", 12, 64, seed=2)
    attn.update(phase_kernels_bias(peaks))
    attn.update(phase_kernels_long(peaks))
    attn.update(phase_kernels_deberta(peaks))
    attn.update(phase_kernels_segment(peaks))
    attn.update(phase_kernels_seg_local(peaks))
    attn_bge = phase_kernels_attention(peaks, "bge-large-en-v1.5", 16, 64, seed=5)
    attn_es = phase_kernels_attention(peaks, "electra-small", 4, 64, seed=6)
    # head dim 96: benchmarks/search.py's ingest model, the head_dims phase
    attn_d96 = phase_kernels_attention(peaks, "384 wide, 4 heads of 96", 4, 96, seed=21)
    headpack = phase_kernels_headpack(peaks)
    k_mesh = phase_kernels_mesh(peaks)
    counters = launch_counters()
    # the eval reference (started before the build) ends before the first
    # phase timed on the host's clock
    t0 = time.perf_counter()
    check(eval_reference.wait(timeout=900) == 0,
          f"eval reference: {(eval_dir / 'reference.log').read_text()[-2000:]}")
    emit({"phase": "eval_reference", "waited_s": time.perf_counter() - t0})
    engine, forward_args, launches, token_lists, main_path = phase_main(counters)
    check(sum(plain_routes().values()) == 0, f"a plain route before head_dims: "
          f"{plain_routes()}")
    head_counts, head_routes = phase_head_dims(counters, token_lists)
    gguf_counts, files = phase_formats(counters, main_path, token_lists)
    phase_native(main_path, files["q4_0"])
    mb, mb_outs, mb_launches, mb_forward_args = phase_modernbert_main(counters, token_lists)
    long_launches = phase_modernbert_long(counters, mb, out_dir)
    phase_modernbert_vs_cpu(counters, mb, mb_outs, token_lists)
    mb_chunk_counts = phase_modernbert_chunks(counters, mb, out_dir)
    rr_counts, rr_timed = phase_modernbert_rerank(counters, peaks)
    de, de_total, de_forward_args = phase_deberta_main(counters, token_lists, out_dir)
    nomic, nomic_outs, nomic_total = phase_nomic_main(counters, token_lists)
    chunks, chunk_counts = phase_nomic_chunks(counters, nomic, out_dir)
    doc_counts = phase_nomic_documents(counters, nomic)
    vs_counts = phase_nomic_vs_cpu(counters, nomic, nomic_outs, token_lists, chunks)
    nomic_2044 = phase_nomic_unaligned(counters, nomic)
    bge, bge_outs, bge_total, bge_forward_args = phase_bge_main(counters, token_lists)
    bge_f32_counts = phase_bge_vs_cpu(counters, bge, bge_outs, token_lists)
    xlmr, xlmr_total, xlmr_forward_args, _ = phase_family_main(
        counters, token_lists, MULTILINGUAL_E5_BASE, "xlmr", seed=16)
    xlmr_rr, xlmr_pair_counts = phase_family_pairs(counters, xlmr.config, "xlmr",
                                                   "xlm-r-base-reranker")
    _, distil_total, _, _ = phase_family_main(counters, token_lists, MULTI_QA_DISTILBERT,
                                              "distilbert", seed=17)
    electra_total, small_total = phase_electra(counters, token_lists)
    mpnet, mpnet_total, mpnet_forward_args, _ = phase_family_main(
        counters, token_lists, MPNET_BASE, "mpnet", seed=18)
    mpnet_rr, mpnet_pair_counts = phase_family_pairs(counters, mpnet.config, "mpnet",
                                                     "all-mpnet-base-reranker")
    t5, t5_total, t5_forward_args, t5_lists = phase_family_main(
        counters, token_lists, GTR_BASE, "t5", seed=19)
    t5_gated_counts = phase_t5_gated(counters)
    albert, albert_total, albert_forward_args, _ = phase_family_main(
        counters, token_lists, ALBERT_BASE, "albert", seed=20)
    albert_rr, albert_pair_counts = phase_family_pairs(counters, albert.config, "albert",
                                                       "albert-base-v2-reranker")
    splade, splade_counts, splade_dec_k, splade_dec, splade_big = phase_splade(
        counters, peaks, synthetic_sentences(2758, seed=0))
    colbert, colbert_counts, colbert_big = phase_colbert(counters, token_lists)
    token_attn = {tag: _attention_at(peaks, "attn_bse_keybias", *big.ids.shape,
                                     big.mask.sum(1), None, False, model=tag)
                  for tag, big in (("splade", splade_big), ("colbert", colbert_big))}
    phase_profile(forward_args, engine, token_lists, out_dir)
    phase_profile(mb_forward_args, mb, token_lists, out_dir, tag="modernbert_")
    phase_profile(de_forward_args, de, token_lists, out_dir, tag="deberta_")
    phase_profile(bge_forward_args, bge, token_lists, out_dir, tag="bge_")
    phase_profile(xlmr_forward_args, xlmr, token_lists, out_dir, tag="xlmr_")
    phase_profile(mpnet_forward_args, mpnet, token_lists, out_dir, tag="mpnet_")
    phase_profile(t5_forward_args, t5, t5_lists, out_dir, tag="t5_")
    phase_profile(albert_forward_args, albert, token_lists, out_dir, tag="albert_")
    phase_server(engine)
    phase_server_frames(engine)
    phase_server(nomic)
    phase_server(bge)
    phase_rerank_server(de)
    phase_rerank_server(xlmr_rr)
    phase_rerank_server(mpnet_rr)
    phase_rerank_server(albert_rr)
    phase_token_frames(splade, colbert)
    vec_path = phase_vector_index(counters, engine)
    sparse_path = phase_sparse_index(counters, splade)
    maxsim_path = phase_maxsim_index(counters, colbert)
    phase_index_scale(engine, colbert, peaks, F32_PEAKS[peaks_for(name)[0]])
    phase_index_frames(engine, splade, colbert)
    http_path = phase_http(counters, files, vec_path["documents_per_sec"], out_dir)
    phase_cli(files)
    mesh_counts = phase_mesh(counters, main_path, token_lists, mpnet)
    phase_distributed(files, synthetic_sentences(2048, seed=3))
    scripts_counts = phase_scripts(counters, files, out_dir)
    files["tmp"].cleanup()
    eval_counts = phase_eval(counters, eval_reference, eval_dir)
    headline_counts = phase_headline(counters, main_path)
    serving_counts = phase_serving(counters)
    scaling_counts = phase_scaling(counters)
    script_counts = phase_retrieval_scripts(counters)
    scripts_tmp.cleanup()

    # each model's launches beside the times at that model's shapes
    mb_total = {k: mb_launches[k] + long_launches[k] + mb_chunk_counts[k] for k in counters}
    k1_mb = {**k1m["per_layer"], "max_abs_err": k1m["max_abs_err"],
             "bound_by": k1m["bound_by"]}
    k1_mini = {**k1["per_layer"], "max_abs_err": k1["max_abs_err"],
               "bound_by": k1["bound_by"]}
    k1_de = {**k1d["per_layer"], "max_abs_err": k1d["max_abs_err"],
             "bound_by": k1d["bound_by"]}
    k1_no = {**k1n["per_layer"], "max_abs_err": k1n["max_abs_err"],
             "bound_by": k1n["bound_by"]}
    nomic_total = {k: nomic_total[k] + chunk_counts[k] + doc_counts[k] + vs_counts[k]
                   for k in counters}
    xlmr_total = {k: xlmr_total[k] + xlmr_pair_counts[k] for k in counters}
    mpnet_total = {k: mpnet_total[k] + mpnet_pair_counts[k] for k in counters}
    albert_total = {k: albert_total[k] + albert_pair_counts[k] for k in counters}
    family_totals = {"xlmr": xlmr_total, "distilbert": distil_total, "electra": electra_total,
                     "mpnet": mpnet_total, "t5": t5_total, "albert": albert_total}
    paths = (launches, mb_total, de_total, nomic_total, bge_total, bge_f32_counts,
             *family_totals.values(), small_total, t5_gated_counts, rr_counts, nomic_2044,
             splade_counts, colbert_counts, vec_path["counts"], sparse_path["counts"],
             maxsim_path["counts"], http_path["launches"], *mesh_counts.values(), eval_counts,
             headline_counts, serving_counts, scaling_counts, *script_counts.values(),
             head_counts, scripts_counts)
    # the fused residual/LayerNorm tail on every model path, bf16 and f32
    ln_on_paths = sum(t["q4_matmul_ln"] for t in paths)
    check(ln_on_paths == 0, f"the fused tail ran on a model path {ln_on_paths} times")
    # B1 too: it is benchmark code, on no model path
    headpack_on_paths = sum(t["attention_headpack"] for t in paths)
    check(headpack_on_paths == 0, f"B1 ran on a model path {headpack_on_paths} times")
    k1_bge = {**k1b["per_layer"], "max_abs_err": k1b["max_abs_err"],
              "bound_by": k1b["bound_by"]}
    k8_layer = {**k8["per_layer"], "max_abs_err": k8["max_abs_err"], "bound_by": k8["bound_by"]}
    kernels = [
        _entry("q4_matmul", "q4_matmul.cu", "q4_matmul.py:126", launches["q4_matmul"],
               k1_mini, "MiniLM-L6: one layer's six linears (q,k,v,o 384->384; up "
               "384->1536 + gelu_erf; down 1536->384) at M=16384, bf16, Q4_0",
               model="minilm-l6", tiles=k1["tiles"],
               forced_tiles={**k1t["forced"], "shape": "up 768->1152 + gelu_erf with "
                             "prologue_mul at M=16384, bf16, Q4_0"}),
        _entry("q4_matmul/modernbert", "q4_matmul.cu", "q4_matmul.py:126",
               mb_total["q4_matmul"], k1_mb, "ModernBERT-base: one layer's seven linears "
               "(q,k,v,o 768->768; up 768->1152 + gelu_erf; gate 768->1152; down "
               "1152->768 with the prologue) at M=16384, bf16, Q4_0",
               model="modernbert-base", tiles=k1m["tiles"]),
        _entry("q4_matmul_prologue", "q4_matmul.cu", "q4_matmul.py:214",
               mb_total["q4_matmul_prologue"], k1m["prologue"],
               "down 1152->768 with prologue_mul at M=16384, bf16, Q4_0",
               model="modernbert-base"),
        _entry("q4_matmul/deberta", "q4_matmul.cu", "q4_matmul.py:126",
               de_total["q4_matmul"], k1_de, "DeBERTa-v3-base: one layer's six linears "
               "(q,k,v,o 768->768; up 768->3072 + gelu_erf; down 3072->768) at M=16384, "
               "bf16, Q4_0 (the two relative-table projections at M=512 apart)",
               model="deberta-v3-base", tiles=k1d["tiles"],
               table_projection={**_timing(k1t["table"]), "tile": k1t["table"]["tile"],
                                 "shape": "512x768 -> 768 + bias, bf16, Q4_0, 2 per layer"}),
        _entry("q4_matmul/nomic", "q4_matmul.cu", "q4_matmul.py:126",
               nomic_total["q4_matmul"], k1_no, "nomic-embed-text-v1.5: one layer's seven "
               "linears (q,k,v,o 768->768; up 768->3072 + silu; gate 768->3072; down "
               "3072->768 with the prologue) at M=16384, bf16, Q4_0", model="nomic-embed",
               tiles=k1n["tiles"]),
        _entry("q4_matmul_prologue/nomic", "q4_matmul.cu", "q4_matmul.py:214",
               nomic_total["q4_matmul_prologue"], k1n["prologue"],
               "down 3072->768 with prologue_mul at M=16384, bf16, Q4_0",
               model="nomic-embed"),
        _entry("q4_matmul/bge-large", "q4_matmul.cu", "q4_matmul.py:126",
               bge_total["q4_matmul"], k1_bge, "bge-large-en-v1.5: one layer's four K1 "
               "linears (q,k,v,o 1024->1024) at M=16384, bf16, Q8_0", model="bge-large",
               f32_check_launches=bge_f32_counts["q4_matmul"], tiles=k1b["tiles"]),
        _entry("q4_matmul_2d", "q4_matmul.cu", "q4_matmul.py:259",
               bge_total["q4_matmul_2d"], k8_layer, "bge-large-en-v1.5: one layer's FFN (up "
               "1024->4096 + gelu_erf; down 4096->1024) at M=16384, bf16, Q8_0",
               model="bge-large", f32_check_launches=bge_f32_counts["q4_matmul_2d"],
               k1_forced_ms=k8["per_layer"]["k1_ms"],
               library="torch.addmm on the dequantized weight (+ gelu)",
               up=_timing(k8["up"]) | {"k1_ms": k8["up"]["k1_ms"], "tile": k8["up"]["tile"]},
               down=_timing(k8["down"]) | {"k1_ms": k8["down"]["k1_ms"],
                                            "tile": k8["down"]["tile"]},
               f32_up={k: k8["f32_up"][k] for k in ("max_abs_err", "ms", "k1_ms", "plain_ms",
                                                     "library_ms", "bound_ms", "bound_by",
                                                     "slice_n")},
               qkvo_forced={k: k8["qkvo_forced"][k] for k in (
                   "max_abs_err", "ms", "k1_ms", "library_ms", "bound_ms", "bound_by")}),
        {**_entry("q4_matmul_ln", "q4_matmul.cu", "q4_matmul.py:219", ln_on_paths,
                  k1ln, "o projection 1024->1024 + gelu_erf + residual + LayerNorm at "
                  "M=16384, bf16, Q8_0", k1_ms=k1ln["k1_ms"], linear_ms=k1ln["linear_ms"]),
         "launches_on_model_paths": ln_on_paths,
         "why": "JAX's linear composes the tail outside the kernel, ops/linear.py:84-94",
         "check_launches": k1ln["check_launches"]}]
    for kname in ("attn_bse_packed", "attn_bse_keybias"):
        for suffix, count, c in (("", launches[kname], attn[kname]),
                                 ("/modernbert", mb_total[kname], attn_mb[kname]),
                                 ("/nomic", nomic_total[kname], attn_mb[kname]),
                                 ("/bge-large", bge_total[kname], attn_bge[kname])):
            extra = ({"f32_check_launches": bge_f32_counts[kname]}
                     if suffix == "/bge-large" else {})
            kernels.append(_entry(kname + suffix, "attention_bse.cu", "attention.py:213",
                                  count, c, f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16",
                                  model=c["model"], **extra))
    # the BERT-graph families: base width runs DeBERTa-v3-base's linear shapes
    # and ModernBERT's [32, 512, 12x64] attention, timed there
    labels = {"xlmr": "XLM-R base (multilingual-e5-base; with bge-reranker-base's head "
                      "on 64 pairs)",
              "distilbert": "multi-qa-distilbert-cos-v1",
              "electra": "ms-marco-electra-base (the score path)",
              "mpnet": "all-mpnet-base-v2 (with a one-logit head on 64 pairs)",
              "albert": "albert-base-v2, one layer applied 12 times (with its pooler + "
                        "classifier on 64 pairs)"}
    k1_t5 = {**k1t5["per_layer"], "max_abs_err": k1t5["max_abs_err"],
             "bound_by": k1t5["bound_by"]}
    # the gated T5 runs the same attention as gtr-t5-base: its K4 launches
    # join that entry's
    t5_attention = {k: t5_total[k] + t5_gated_counts[k]
                    for k in ("attn_bse_bias_packed", "attn_bse_bias")}
    for tag, total in family_totals.items():
        if tag == "t5":
            kernels.append(_entry(
                "q4_matmul/t5", "q4_matmul.cu", "q4_matmul.py:126", total["q4_matmul"], k1_t5,
                "gtr-t5-base: one layer's six bias-free linears (q,k,v,o 768->768; up "
                "768->3072, relu after it; down 3072->768) at M=16384, bf16, Q4_0",
                model=tag, tiles=k1t5["tiles"]))
        else:
            kernels.append(_entry(
                f"q4_matmul/{tag}", "q4_matmul.cu", "q4_matmul.py:126", total["q4_matmul"],
                k1_de, f"{labels[tag]}: one layer's six linears (q,k,v,o 768->768; up "
                "768->3072 + gelu; down 3072->768) at M=16384, bf16, Q4_0: the shapes of "
                "q4_matmul/deberta, timed there", model=tag, tiles=k1d["tiles"]))
        if tag in ("mpnet", "t5"):
            for kname in ("attn_bse_bias_packed", "attn_bse_bias"):
                c = attn[f"{kname}/ph12"]
                n = t5_attention[kname] if tag == "t5" else total[kname]
                kernels.append(_entry(
                    f"{kname}/{tag}", "attention_bse.cu", "attention.py:213", n, c,
                    f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, a per-head [12, S, S] "
                    "bias (PH = H); every [B, S] of the forwards checked untimed with the "
                    "model's own bias", model=tag))
            continue
        for kname in ("attn_bse_packed", "attn_bse_keybias")[tag == "electra":]:
            c = attn_mb[kname]
            kernels.append(_entry(f"{kname}/{tag}", "attention_bse.cu", "attention.py:213",
                                  total[kname], c, f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] "
                                  "bf16, timed at the ModernBERT/nomic entries' shape",
                                  model=tag))
    k1_t5g = {**k1t5g["per_layer"], "max_abs_err": k1t5g["max_abs_err"],
              "bound_by": k1t5g["bound_by"]}
    kernels.append(_entry("q4_matmul/t5-v1.1", "q4_matmul.cu", "q4_matmul.py:126",
                          t5_gated_counts["q4_matmul"], k1_t5g, "t5-v1.1-base (gated "
                          "gelu_tanh): one layer's seven bias-free linears (q,k,v,o 768->768; "
                          "up 768->2048 + gelu_tanh; gate 768->2048; down 2048->768 with the "
                          "prologue) at M=16384, bf16, Q4_0", model="t5-v1.1",
                          tiles=k1t5g["tiles"]))
    kernels.append(_entry("q4_matmul_prologue/t5-v1.1", "q4_matmul.cu", "q4_matmul.py:214",
                          t5_gated_counts["q4_matmul_prologue"], k1t5g["prologue"],
                          "down 2048->768 with prologue_mul at M=16384, bf16, Q4_0",
                          model="t5-v1.1"))
    k1_es = {**k1es["per_layer"], "max_abs_err": k1es["max_abs_err"],
             "bound_by": k1es["bound_by"]}
    kernels.append(_entry("q4_matmul/electra-small", "q4_matmul.cu", "q4_matmul.py:126",
                          small_total["q4_matmul"], k1_es, "ELECTRA-small: one layer's six "
                          "linears (q,k,v,o 256->256; up 256->1024 + gelu_erf; down "
                          "1024->256) at M=16384, bf16, Q4_0", model="electra-small",
                          tiles=k1es["tiles"]))
    c = attn_es["attn_bse_packed"]
    kernels.append(_entry("attn_bse_packed/electra-small", "attention_bse.cu",
                          "attention.py:213", small_total["attn_bse_packed"], c,
                          f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16", model="electra-small"))
    for kname in ("attn_bse_bias", "attn_bse_bias_packed"):
        c = attn[kname]
        kernels.append(_entry(kname, "attention_bse.cu", "attention.py:213",
                              mb_total[kname], c,
                              f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, "
                              "[1, S, S] window-128 bias", model="modernbert-base"))
    c = attn["attn_long"]
    kernels.append(_entry("attn_long", "attention_long.cu", "attention.py:26",
                          mb_total["attn_long"], c,
                          f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, key padding",
                          model="modernbert-base",
                          bias_case={**_timing(attn["attn_long_bias"]),
                                     "shape": "[8, 2048, 12*64] bf16, [1, S, S] bias"}))
    c = attn["attn_local"]
    kernels.append(_entry("attn_local", "attention_long.cu", "attention.py:597",
                          mb_total["attn_local"], c,
                          f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, window 128",
                          model="modernbert-base"))
    for kname, line, what in (("deberta_attn", 76, "key padding"),
                              ("deberta_attn_packed", 185, "64 segments per row")):
        c = attn[kname]
        kernels.append(_entry(kname, "deberta_attention.cu", f"deberta_attention.py:{line}",
                              de_total[kname], c,
                              f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, span "
                              f"{c['span']}, max_dist {c['max_dist']}, {what}",
                              model="deberta-v3-base",
                              library="SDPA with the materialised [B, H, S, S] c2p+p2c "
                                      "bias (bias build not timed)"))
    c = attn["attn_long"]
    kernels.append(_entry("attn_long/nomic", "attention_long.cu", "attention.py:26",
                          nomic_total["attn_long"], c,
                          f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, key padding",
                          model="nomic-embed"))
    for kname, line, what in (("attn_seg", 418, "every key (wmax = S)"),
                              ("attn_seg_window", 500, "the tile's key slice")):
        c = attn[kname]
        kernels.append(_entry(kname, "attention_long.cu", f"attention.py:{line}",
                              nomic_total[kname], c,
                              f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, segments of "
                              f"{c['segments'][0]}-{c['segments'][1]} tokens, max_seg_len "
                              f"{c['max_seg_len']}, {what}: tq {c['tq']}, wmax {c['wmax']}",
                              model="nomic-embed",
                              bound_ms_key_slice=c["bound_ms_key_slice"],
                              pair_share=c["pair_share"],
                              library="SDPA with the boolean block-diagonal [B, 1, S, S] mask"))
    # the segment + sliding-window mode (no TPU kernel: XLA in the reference)
    c = attn["attn_seg_local"]
    kernels.append({
        **_entry("attn_seg_local", "attention_long.cu", "", mb_total["attn_seg_local"], c,
                 f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, window {c['window']}, "
                 f"segments of {c['segments']}: tq {c['tq']}, wmax {c['wmax']}",
                 model="modernbert-base", pair_share=c["pair_share"],
                 library="SDPA with the boolean [B, 1, S, S] segment-and-window mask"),
        "replaces": "embedding_cpp_tpu/models/modernbert.py:360 (XLA; no TPU kernel)"})
    for kname, line, what in (("attn_seg_window", 500, "chunk rows, max_seg_len 512"),
                              ("attn_seg", 418, "documents packed always, every key")):
        c = attn[kname]
        kernels.append(_entry(f"{kname}/modernbert", "attention_long.cu", f"attention.py:{line}",
                              mb_total[kname], c,
                              f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16 ({what}): "
                              "the shape of the nomic entry, timed there",
                              model="modernbert-base",
                              library="SDPA with the boolean block-diagonal [B, 1, S, S] mask"))
    c = attn["attn_seg_window"]
    kernels.append(_entry("attn_seg_window/nomic-2044", "attention_long.cu", "attention.py:500",
                          nomic_2044["attn_seg_window"], c,
                          "rows of 2044 padded to [8, 2048, 12*64] bf16 inside the call: "
                          "the nomic entry's shape, timed there", model="nomic-embed",
                          library="SDPA with the boolean block-diagonal [B, 1, S, S] mask"))
    kernels.append(_entry("q4_matmul/modernbert-rerank", "q4_matmul.cu", "q4_matmul.py:126",
                          rr_counts["q4_matmul"], k1_mb, "gte-reranker-modernbert-base: the "
                          "linears of q4_matmul/modernbert (its K and N), timed there at "
                          "M=16384", model="gte-reranker-modernbert-base", tiles=k1m["tiles"]))
    for kname, src, line in (("attn_bse_keybias", "attention_bse.cu", "attention.py:213"),
                             ("attn_bse_bias", "attention_bse.cu", "attention.py:213"),
                             ("attn_long", "attention_long.cu", "attention.py:26"),
                             ("attn_local", "attention_long.cu", "attention.py:597")):
        c = rr_timed[kname]
        kernels.append(_entry(f"{kname}/modernbert-rerank", src, line, rr_counts[kname], c,
                              f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, the path's "
                              f"largest batch, window {c['window']}",
                              model="gte-reranker-modernbert-base",
                              library="SDPA with the same additive mask"))
    k1_base = {**k1d["per_layer"], "max_abs_err": k1d["max_abs_err"], "bound_by": k1d["bound_by"]}
    for tag, total in (("splade", splade_counts), ("colbert", colbert_counts)):
        encoder = total["q4_matmul"] - (splade_dec["1d"] if tag == "splade" else 0)
        name = "q4_matmul/splade-encoder" if tag == "splade" else f"q4_matmul/{tag}"
        kernels.append(_entry(name, "q4_matmul.cu", "q4_matmul.py:126", encoder,
                              k1_base, "BERT-base encoder: the linears of q4_matmul/deberta "
                              "(q,k,v,o 768->768; up 768->3072; down 3072->768), timed there "
                              "at M=16384", model=tag, tiles=k1d["tiles"]))
        c = token_attn[tag]
        kernels.append(_entry(f"attn_bse_keybias/{tag}", "attention_bse.cu", "attention.py:213",
                              total["attn_bse_keybias"], c,
                              f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16, the path's "
                              "largest batch", model=tag,
                              library="SDPA with the same additive mask"))
    for kname, kernel_line, n in (("q4_matmul", 126, splade_dec["1d"]),
                                  ("q4_matmul_2d", 259, splade_dec["2d"])):
        if n:
            kernels.append(_entry(
                f"{kname}/splade", "q4_matmul.cu", f"q4_matmul.py:{kernel_line}", n, splade_dec_k,
                f"the tied decoder: [{splade_dec_k['m']}, 768] x [768, 30522] + bias, bf16, "
                f"Q4_0 (route: {splade_dec_k['route']})", model="splade",
                k8_forced_ms=splade_dec_k["k8_forced_ms"],
                library="torch.addmm on the dequantized weight"))
    # the indexes' ingest paths, each kernel timed at its model's entry above
    sources = {"q4_matmul": ("q4_matmul.cu", "q4_matmul.py:126"),
               "q4_matmul_2d": ("q4_matmul.cu", "q4_matmul.py:259"),
               "attn_bse_packed": ("attention_bse.cu", "attention.py:213"),
               "attn_bse_keybias": ("attention_bse.cu", "attention.py:213")}
    minilm_timed = {"q4_matmul": k1_mini, "attn_bse_packed": attn["attn_bse_packed"],
                    "attn_bse_keybias": attn["attn_bse_keybias"]}
    retrieval = {
        "vector-index": (vec_path["counts"], "MiniLM-L6 (VectorIndex.add over the corpus)",
                         minilm_timed),
        "http": (http_path["launches"], "MiniLM-L6 from the port-written Q4_0 GGUF behind "
                 "POST /v1/embeddings (256 texts a request)", minilm_timed),
        "sparse-index": (sparse_path["counts"], "SPLADE, BERT-base (SparseIndex.add and the "
                         "hybrid index over the corpus; K1 counts the decoder's 1-D launches)",
                         {"q4_matmul": k1_base, "q4_matmul_2d": splade_dec_k,
                          "attn_bse_packed": attn_mb["attn_bse_packed"],
                          "attn_bse_keybias": token_attn["splade"]}),
        "maxsim-index": (maxsim_path["counts"], "ColBERT, BERT-base (MaxSimIndex.add over the "
                         "corpus)", {"q4_matmul": k1_base,
                                     "attn_bse_keybias": token_attn["colbert"]}),
        # the user-level scripts (benchmarks/): MiniLM-L6 shapes unless named
        "eval": (eval_counts, "MiniLM-L6 through benchmarks/run_eval.py --synthetic (the card's "
                 "f32 and bf16 runs, every engine mode; K1 in q4_0, q4_1 and q8_0)",
                 minilm_timed),
        "headline": (headline_counts, "MiniLM-L6 through benchmarks/bench.py (run_headline with "
                     "its in-device forwards, run_ab_transfer)", minilm_timed),
        "serving": (serving_counts, "MiniLM-L6 behind benchmarks/serving.py (TCP f32 and int8, "
                    "HTTP base64, the serving-tax A/B)", minilm_timed),
        "scaling": (scaling_counts, "benchmarks/scaling.py's MiniLM-L6-shaped f32 forward on dp "
                    "1, 2 and 4 slots of the card (the f32 kernels; timed at the bf16 entries)",
                    minilm_timed),
        "search-bench": (script_counts["search"], "benchmarks/search.py's one-layer f32 "
                         "ingest model (384 wide, 4 heads of 96)",
                         {k: attn_d96[k] for k in ("attn_bse_packed", "attn_bse_keybias")}),
        "sparse-bench": (script_counts["sparse"], "benchmarks/sparse.py's splade-base forward "
                         "and Engine.encode_sparse / maxsim (K1 counts the decoder's 1-D "
                         "launches)", {"q4_matmul": k1_base, "q4_matmul_2d": splade_dec_k,
                                       "attn_bse_packed": attn_mb["attn_bse_packed"],
                                       "attn_bse_keybias": token_attn["splade"]})}
    for tag, (counts, label, timed) in retrieval.items():
        for kname, c in timed.items():
            if counts[kname]:
                src, line = sources[kname]
                kernels.append(_entry(f"{kname}/{tag}", src, line, counts[kname], c,
                                      f"{label}: timed at the shape of that model's "
                                      f"{kname} entry", model=tag))
    # head dim 96 (the head_dims phase's Engine; search.py's entry above)
    for kname in ("attn_bse_packed", "attn_bse_keybias"):
        c = attn_d96[kname]
        kernels.append(_entry(f"{kname}/d96", "attention_bse.cu", "attention.py:213",
                              head_counts[kname], c, f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] "
                              "bf16: the head_dims phase's Engine, 384 wide with 4 heads of 96",
                              model="minilm-l6-4x96"))
    # the breakdown and A/B scripts, each kernel timed at its main-path entry
    scripts_timed = {"q4_matmul": k1_mini, "q4_matmul_prologue": k1m["prologue"],
                     "q4_matmul_2d": k8_layer,
                     **{k: attn[k] for k in ATTENTION}}
    for kname, n in scripts_counts.items():
        if n and kname not in ("q4_matmul_ln", "attention_headpack"):
            check(kname in scripts_timed, f"the scripts launched {kname}, timed nowhere")
            c = scripts_timed[kname]
            src = ("q4_matmul.cu" if kname.startswith("q4") else "deberta_attention.cu"
                   if kname.startswith("deberta") else "attention_bse.cu"
                   if kname.startswith("attn_bse") else "attention_long.cu")
            kernels.append({**_entry(
                f"{kname}/scripts", src, KERNEL_LINES[kname], n, c,
                "benchmarks/{forward_breakdown,modernbert_breakdown,packed_bse_ab,"
                "attn_bias_smoke}.py and the kernel suite's full-forward modes: timed at "
                f"the shape of the {kname} entry", model="scripts"),
                **({"replaces": "embedding_cpp_tpu/models/modernbert.py:360 (XLA; no TPU "
                                "kernel)"} if kname == "attn_seg_local" else {})})
    # the formats phase: the main path loaded from a port-written Q4_0 GGUF
    kernels.append(_entry("q4_matmul/gguf", "q4_matmul.cu", "q4_matmul.py:126",
                          gguf_counts["q4_matmul"], k1_mini, "MiniLM-L6 loaded by "
                          "Engine.from_gguf from a Q4_0 file the port converted and quantized: "
                          "the linears of the q4_matmul entry, timed there", model="minilm-l6"))
    for kname in ("attn_bse_packed", "attn_bse_keybias"):
        c = attn[kname]
        kernels.append(_entry(f"{kname}/gguf", "attention_bse.cu", "attention.py:213",
                              gguf_counts[kname], c, f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] "
                              "bf16, MiniLM-L6 from the port-written Q4_0 GGUF: the shape of "
                              f"the {kname} entry, timed there", model="minilm-l6"))
    # the mesh phase: each tp shard's shapes, every slot's launches
    mesh_k1 = k_mesh["k1"]
    kernels.append(_entry(
        "q4_matmul/mesh", "q4_matmul.cu", "q4_matmul.py:126",
        mesh_counts["minilm"]["q4_matmul"] + mesh_counts["mpnet"]["q4_matmul"], mesh_k1["o/tp2"],
        "MiniLM-L6's o projection at tp=2: a row-parallel shard 192->384, out_f32, no bias, "
        "at M=16384, bf16, Q4_0 (launches: every slot of the mesh phase, MiniLM-L6 at dp 2 x "
        "tp 2 and dp 1 x tp 4, MPNet at tp 2)", model="minilm-l6/mesh",
        **{k.replace("/", "_"): _timing(c) | {"k": c["k"], "n": c["n"], "tile": c["tile"]}
           for k, c in mesh_k1.items() if k != "o/tp2"}))
    for kname, model in (("attn_bse_packed", "minilm"), ("attn_bse_keybias", "minilm"),
                         ("attn_bse_bias", "mpnet"), ("attn_bse_bias_packed", "mpnet")):
        c = k_mesh[f"{kname}/h6"]
        extra = ({"h3": _timing(k_mesh[f"{kname}/h3"]) | {"shape": "[32, 512, 3*32] bf16"}}
                 if f"{kname}/h3" in k_mesh else {})
        what = ("MPNet's tp=2 shard, the [6, S, S] slice of its relative bias"
                if model == "mpnet" else "MiniLM-L6's tp=2 shard (h3: its tp=4 shard)")
        kernels.append(_entry(f"{kname}/mesh", "attention_bse.cu", "attention.py:213",
                              mesh_counts[model][kname], c,
                              f"[{c['b']}, {c['s']}, {c['h']}*{c['d']}] bf16: {what}",
                              model=f"{model}/mesh", **extra))
    c = headpack["d32_hb4"]
    kernels.append({
        **_entry("attention_headpack", "attention_headpack.cu", "", headpack_on_paths, c,
                 f"[{c['b']}, {c['h']}, {c['s']}, {c['d']}] bf16 head-major, hb {c['hb']}, "
                 "zero bias", k5_ms=c["k5_ms"], k3_ms=c["k3_ms"],
                 library="SDPA with the additive mask, [B, H, S, d]",
                 d64_hb2={**_timing(headpack["d64_hb2"]),
                          "k5_ms": headpack["d64_hb2"]["k5_ms"],
                          "k3_ms": headpack["d64_hb2"]["k3_ms"],
                          "shape": "[32, 12, 512, 64] bf16 head-major, hb 2, zero bias"}),
        "replaces": "benchmarks/kernels.py:234",
        "launches_on_model_paths": headpack_on_paths,
        "why": "benchmark code: the kernel suite's head-packing A/B, on no model path",
        "check_launches": headpack["check_launches"]})
    # every kernel ran on its model path; the fused tail and B1 run on none
    check(all(k["launches"] > 0 for k in kernels
              if k["name"] not in ("q4_matmul_ln", "attention_headpack")),
          f"a kernel was never launched: {[(k['name'], k['launches']) for k in kernels]}")
    totals = plain_routes()
    emit({"phase": "plain_routes", "totals": totals, "head_dims_d24": head_routes})
    check(totals == head_routes, f"a plain route outside the head_dims phase's d 24: {totals}")
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
