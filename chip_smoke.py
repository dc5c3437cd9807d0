#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

Run from a checkout of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printed as it ends:

1. the card (name and power limit, as nvidia-smi gives them);
2. the build of every CUDA kernel from the repository's sources, one
   nvcc per source, all started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the training and decoding paths give it, with its time beside
   its bound, the plain version's time and a PyTorch yardstick: K1 (LSTM
   gates), K3/K4 (the fused joint) at the paper-width client step, at
   a ragged small shape, at a J that is not a multiple of 4 and at the
   fedsgd round's one step over 32 examples (B=32; K3's three
   launches and K4's five each alone as well, the products beside the same
   run's fp32 torch.matmul; K3 twice and replayed from one CUDA graph for
   the same bits), and K2 (the
   full-sequence recurrence) at the
   paper's encoder and predictor layers (at B=4, and at the fedsgd
   round's B=32), the decoder's encoder and a
   ragged small shape; every backward runs twice and must give the same
   bits; K1 also with the host's cost of each piece of its launch path
   (the PyTorch operators) and every refusal of its ``_check`` made on
   the card; K2's backward gate recompute also alone, beside one fp32
   matmul of the same product; K2's backward recurrence (that gate
   recompute hoisted out of the steps, then the recurrence) also replayed
   twice from one CUDA graph, at B=5, B=8 and H=1153 (a partial last
   block), and its recurrence's phases, and the forward's, timed by their
   timed instantiations;
   the normal kernel (FVN's noise, the gaussian adversary's, the DP
   noise: jax.random.normal drawn in the kernel and added, scaled, to a
   table of leaves in one launch) against its plain version bit for bit
   at rnnt-librispeech's 35 leaves, at ragged sizes with bf16 leaves and
   every kind of scale, and over 70 small leaves (two launches), timed
   beside the per-leaf randn path it replaced and one torch.randn;
   The compression plane's kernels (K5-K8: the quantizer, keyed,
   streamed and nearest, the int4 nibble pack and unpack, and the top-k
   scatter-add) run at K=4 clients on the paper's largest leaf
   (n=5,308,416), at n=4,096 and at ragged sizes, and must give the
   plain versions' bits (the quantizer also at QUANT_EDGE_SIZES, n = 10**8
   among them); the scatter-add runs twice for the same bits,
   also with -0.0 values, negative and zero weights and indices out of
   range, from one CUDA graph at the largest leaf, and at n=10**8 (K=4,
   1 % a row: its rows sorted by window groups);
   K7's dequantize and K9's top-k unpack (the slow path's packed wire)
   run at the same shapes, K9 also with repeated and out-of-range
   indices and runs across its windows' edges (its starts and slots held
   to the plain layout's, and replayed from one CUDA graph), and past the
   sort's histogram (n=75,497,473 and 2·10⁸, by window groups),
   and the quantizer also with a scale for each client; the keyed
   quantizer and K7 also at K=1 (the fedsgd aggregate's compress) at the
   same sizes; all bitwise;
   K8's and K9's device time by launch under the profiler; K10 under
   autograd (one forward with its log-sum-exp, one backward call, the
   gradients bitwise those of direct calls); K2's dw product also
   at ragged shapes (S·B = 37, H = 100 and 99) and with its occupancy;
   K10 (flash attention) and K11 (flash decode) in bf16 and fp32 at
   whisper-base's shapes (the encoder, B=4, 1,500 frames, 8 heads of 64;
   the decoder's cross-attention at Sq=4 and 448 against 1,500 frames;
   its causal self-attention over the 4-token prompt, over 64 tokens and
   at 448; the self cache of 448 slots at
   positions 3, 200 and 447, at both sides of K11's first split edge,
   and the cross cache of 1,500), a ragged GQA
   shape with a window, softcap and query offset for each, K10 rows
   with no valid key (which must be 0), and qwen3-8b's head layout (32
   query heads on 8 kv heads of 128: K10 causal over 128 tokens, K11 over
   a 128-slot cache); each timed beside
   ``scaled_dot_product_attention`` on the same inputs, a yardstick;
   every bf16 K10 shape on the tensor-core route (at the encoder at most
   2 % of its outputs may differ from the plain version's bf16 result),
   every fp32 one on the CUDA-core route; each K11 launch twice for the
   same bits, and K11 replayed from one CUDA graph while pos advances on
   the device, each replay held to the plain version;
   K10's backward against its plain version in bf16 and fp32 at
   whisper-base's training shapes (the encoder, 4 x 384 frames; the
   decoder's causal self-attention over 48 tokens and its cross-attention,
   48 against 384), at the ragged GQA row, the rows with no valid key and
   qwen3-8b's head layout above, every bf16 call on the tensor-core route
   (csrc/attention_bwd_wgmma.cu) and every fp32 one on the CUDA-core route
   (csrc/attention_bwd.cu), the bf16 shapes also on the CUDA-core design
   through its C entry, the forward's o bitwise unchanged by its
   log-sum-exp write, each call twice for the same bits, timed beside the
   plain version, SDPA's backward and the bound, with each launch's device
   time; K10, its backward and K11 also at zamba2-7b's head layout (32
   heads on 32 kv heads of 112: the forward pads 112 to 128 columns); K10
   and its backward at deepseek-v2-lite-16b's multi-head latent attention
   (16 heads, q.k width 192, v width 128, MLA's scale: the tensor-core
   forward's ND = 3 and the backward's two-warpgroup dK/dV, the CUDA-core
   routes' 192-wide tiles) and at those widths with a window, a softcap,
   H = 2 Kv, Sq = 100 against Sk = 130 and a query offset, the SDPA
   backends that take D != Dv named; K10 and its backward at
   llava-next-mistral-7b's layout with Mistral's window acting (B=1,
   Sq=Sk=4,672: 576 image + 4,096 text positions, 32 heads on 8 kv heads
   of 128, causal, window 4,096), timed beside SDPA given the window as an
   explicit boolean mask (the backends that take it named), and K11 at its
   serve (B=4, 736 slots at pos 735, G=4, D=128, window 4,096); K10 and
   its backward at gemma3-4b's heads of 256 (B=1, Sq=Sk=4,096, 8 heads on 4
   kv heads, D=Dv=256, causal: a local layer with the window of 1,024, SDPA
   given it as a boolean mask, and the global layer, SDPA with is_causal;
   the tensor-core forward's two warpgroups, the backward's column halves,
   the CUDA-core routes' tiles of 256) and a ragged row at those widths
   (Sq=Sk=1,000, window 300, softcap 30), and K11 at gemma3's serve (B=4,
   1,184 slots at pos 1,183, G=2, D=256, with the window of 1,024 and
   without; SDPA over the valid slots), the SDPA backends named; every K10
   forward launched twice for the same bits; K12
   (WKV-6) and K13 (Mamba2's scan), forward and backward, against their
   plain versions at the full-size training shapes (rwkv6-1.6b: B=4,
   S=128, H=32, P=64; zamba2-7b: H=112, P=64, N=64), the decode steps from
   a state, a ragged length past two checkpoint chunks and the tiny tasks'
   widths, each call twice for the same bits, timed beside the plain
   version and the bound (a forward as the path calls it: with checkpoints
   in training, none at a decode step), each kernel's block printed;
4. one tiny FedAvg round (FVN on) and one tiny greedy decode on the card
   against the same on the CPU, under each LSTM dispatch ('ref': the time loop;
   'kernel': K2 on the card, its plain version on the CPU); the
   code-domain aggregate of the same tiny deltas on the card and on the
   CPU, bitwise, under every compressed plane; the slow path's server
   stage (compression, corruption, aggregation after the drawn cohort)
   on the same tiny deltas under each slow-path plane below, bitwise but
   for the planes that draw through ``normal`` (a stated tolerance);
   whisper-base's smoke config served on the card and on the CPU (fp32
   and bf16): prefill over a 4-token prompt (6 K10 launches) and 8 decode
   steps (4 K11 launches each), the logits held to each other; the
   experiment ladder's round paths at the tiny config (a fedsgd round with
   FVN, one with an int4 packed uplink at participation 0.75, an IID round,
   a label-shuffle round, a yogi and a momentum server) on the card and on
   the CPU, held to each other, and the fedsgd aggregate's K = 1 compress
   of the same tiny deltas bitwise; an asr-encdec round (the reference's
   encdec-tiny, FVN on) on the card (K10's CUDA-core route and its
   backward, exact launches) and on the CPU under each dispatch; the
   latency model's arrival times from keys on the card bitwise the CPU's,
   and XLA's exp restated (ref.xla_exp_f32) the same on both; one FedAvg
   round (K=4, b=4, 2 local steps, FVN on) of each of the reference's
   lm-transformer, lm-moe, lm-rwkv and keyword tasks, of zamba2-7b's
   smoke hybrid, of deepseek-v2-lite-16b's smoke MLA transformer and of
   gemma3's smoke transformer at heads of 256 (K10's CUDA-core tiles of
   256 through a whole round) on the
   card and on the CPU, held to each other (K10 on its CUDA-core routes,
   once an attention a client step, K12 once an RWKV layer, K13 once a
   Mamba2 layer, forward and backward); each assigned architecture of the
   ``--arch`` registry (all but rnnt-librispeech) served at its smoke
   config (fp32) through the serve_lm twin (``repro_torch.examples.
   serve_lm``): a 4-token prompt decoded token by token and 8 greedy steps
   at B=4, its kernels' launches exact (K11 once a self-attention layer a
   step, whisper's cross-attention too, none with MLA; K12 or K13 once a
   recurrent layer a step), then the same serve on the CPU from the same
   parameters and prompt: the greedy token ids identical and every
   step's logits within TINY_SERVE_TOL of the largest;
5. rounds of the paper-width RNN-T (rnnt-librispeech, 105M parameters)
   through the training entry point, each with its launch counts over
   the training rounds and over the final greedy-decode evaluation (WER
   on the clean and hard splits): on the time loop (K1) with the chunked
   joint and with the fused joint kernels (``use_kernel=True``), then on
   K2 (``lstm.scan_dispatch=auto``) with the fused joint, whose loss is
   held to the time loop's and whose losses must equal K2_ROUND_LOSSES
   bit for bit; every run launches the normal kernel once a client step
   (FVN), and once more a round for the gaussian adversary and for the DP
   noise;
   then four compressed runs on the K2 path (int4 packed, int4 packed
   with error feedback, top-k 0.05 with error feedback, int8 with nearest
   rounding) and four runs of the slow path (SLOWPATH: robust
   aggregators, delta adversaries, partial cohorts, the latency model),
   with no evaluation, each two counted rounds and a third under
   torch.profiler: exact launch counts of the plane kernels (one per
   leaf, 35 a round), the exact uplink bytes per (reporting) client, the
   plane's span in CUDA events and its share of the profiled round, the
   busy share; for the compressed runs and the slow path's full cohorts a
   first-round loss equal to the uncompressed run's; for the slow path
   the participants and corrupted clients of each round, and server
   parameters of the packed int4 run and its unpacked twin equal bit for
   bit after every round;
   then the experiment ladder's runs (PAPER_LADDER): E0 on IID rounds with
   its final evaluation, E10 with SpecAugment's masks doubled, the
   label-shuffle adversary at rate 0.5 (each round's corrupted clients
   those of a second host sampler from the seed), the fedsgd engine (one
   forward and backward over the round's 32 examples: each K2 kernel once
   a layer, each joint kernel and the normal kernel once a round) and the
   fedsgd engine with an int4 packed uplink (its three plane kernels 35
   times a round), each two rounds with exact launch counts;
   then the async engine (core/async_engine.py): two waves at the
   sync-parity plane (a buffer of K = 4, one device tier, no jitter), whose
   losses must equal K2_ROUND_LOSSES and whose server parameters after wave
   2 must equal the K2 sync run's bit for bit, one flush at staleness 0 a
   wave; three waves with a buffer of 3, the staleness discount, the
   latency model and an int4 packed uplink (the flushes and staleness of
   the buffer's arithmetic, simulated seconds against the barrier's, the
   K2 round's launches plus the materialized compressor's three plane
   kernels 35 times a wave, the exact uplink bytes, the third wave
   profiled); two K2 rounds with the per-client plane on (a panel of 6
   clients, 4 examples each: each round's measure timed with its exact
   K1, K2 and K3 launches, a finite spread) and a checkpoint directory
   (each save timed; the restored parameters bitwise the final ones); the
   sweep runner's async_vs_sync and client_eval smoke grids at the tiny
   task, each with its --check; and a paper-width async_vs_sync pair
   through SweepRunner (B=3, 3 rounds, latency on) held to
   check_async_vs_sync;
   then whisper-base served at full width (70,857,216 bf16 parameters,
   random from a seed) through the model bundle: 4 utterances of 1,500
   frames, Whisper's 4-token prompt, prefill (18 K10 launches, 6 of them
   in its encode), the caches grown to 448 slots, 60 greedy decode steps
   (12 K11 launches each, 720 in all), with the encode, prefill and
   per-token times and peak memory; the decode's logits held to the
   teacher-forced decode_train over the same 64 tokens (12 K10 launches)
   and one teacher-forced loss_fn forward at 448 positions (18 K10);
   every K10 launch of the serve on the tensor-core route;
   then whisper-base trained at full width through the training entry
   point on a corpus at its widths (frames 512 wide, T = 384, U = 48;
   its build timed and sized): two FedAvg rounds (K=4, b=4, 2 local
   steps, FVN 0.01) with exact launches (K10's forward, on the tensor
   cores, and its backward, 18 each a client step), the perplexity
   evaluation (16 examples of each split) and the per-client panel (6 x
   4), one round profiled (busy share), and the first round again with
   K10's forward and backward swapped for their plain versions on the
   card, its loss within WHISPER_LOSS_RTOL;
   and, run second, after qwen3-8b's phases below, gemma3-4b at full width
   and 6 of its 34 layers (1,908,444,672 bf16 parameters: 5 local layers of
   a 1,024-token window to 1 global, heads of 256, a 262,144-word
   vocabulary) trained as llava-next-mistral-7b below (make_round_step on a
   seeded round batch in lm_train_batch's layout at train_4k: K=4, b=1, 2
   local steps, FVN 0.01, Adam at 1e-5): two rounds with exact launches a
   client step (K10's forward 6, 5 with the window, on
   flash_attention_wgmma_wide_kernel<4, 128>, its backward 6 on the column
   halves, the normal kernel 1), round times, peak memory, a profiled round,
   the first client step's loss and logits at 4,096 positions against the
   plain attention's; then served (_serve_transformer): B=4 prompts of
   1,152 seeded tokens, prefill (K10 6), the cache grown to 1,184 slots, 32
   greedy steps (K11 6 each, on its instantiation for 256 columns), the
   window masking keys past position 1,024 in the local layers, each step's
   logits held to a teacher-forced forward within QWEN_SERVE_TOL;
   and, run first of all the phases after the build (its 68 GB peak on an
   80 GB H100 needs an allocator the other phases have not fragmented),
   qwen3-8b trained (phase_lm_train, QWEN_RUN)
   at full width and 4 of its 36 layers
   (2,016,449,536 bf16 parameters, random from a seed) through the
   training entry point on a corpus at its vocabulary (label rows of 128
   tokens over 151,936 word-pieces): two FedAvg rounds (K=4, b=4, 2 local
   steps, FVN 0.01) with exact launches a client step (K10's forward 4 on
   flash_attention_wgmma_kernel<2, 128> and its backward 4 on the <2, 2>
   kernels, the normal kernel 1), round times, examples per second, peak
   memory, the perplexity evaluation, one round profiled (device time by
   kernel, busy share), and the first round again on the plain attention
   within QWEN_RUN.loss_rtol; then the trained model served: B=4 prompts of
   128 tokens, prefill (K10 4), 32 greedy decode steps (K11 4 each), each
   step's logits held to a teacher-forced forward within QWEN_SERVE_TOL;
   then, each through the same phase_lm_train (RWKV_RUN, ZAMBA_RUN; the
   allocator's cache emptied between the big phases, largest peak first),
   rwkv6-1.6b at its full size (24 layers, 1,584,091,136 bf16 parameters;
   K12 24 forward and 24 backward a client step, the first round again on
   K12's plain versions on the card, its loss printed, not held) and
   zamba2-7b at full width and 7 of
   its 81 layers (980,754,096 parameters; K13 7 and 7, K10 2 and 2 on
   <2, 112> and <2, 2>, the first round again on the plain K10 and K13),
   each run's trained model also one forward on the kernels and one on
   their plain versions (LMRun.forward_rtol), and each served by
   phase_recurrent_serve at B=4: rwkv6-1.6b by prefill over 128 tokens and
   32 decode steps, zamba2-7b by 160 decode steps (its reference has no
   prefill), each step's logits held to a teacher-forced forward within
   QWEN_SERVE_TOL unless that forward's floor (it again on the plain
   versions) passes the bar, K12's or K13's device time in the profiled
   windows printed, then the same serve on an fp32 copy of the parameters
   within FP32_SERVE_TOL; then deepseek-v2-lite-16b (DEEPSEEK_RUN) at full
   width and 2 of its 27 layers, both with multi-head latent attention
   (1,085,287,424 parameters, bf16 beside the fp32 router), trained as
   qwen3-8b (K10's forward 2 on <3, 128> and its backward 2 on <3, 2> a
   client step, the first round again on the plain attention) and served
   by the same phase_transformer_serve (prefill K10 2; its decode scores
   the compressed cache in plain einsums: no K11), its bf16 logits held as
   qwen3-8b's at the positions the decode routes to the teacher-forced
   forward's experts (at most MAX_REROUTED_SHARE rerouted) where its floor
   allows, an fp32 copy's within FP32_SERVE_TOL; then
   llava-next-mistral-7b at full width and 4 of its 32 layers
   (1,155,575,808 bf16 parameters; Mistral's 4,096-token window in every
   layer) trained as the reference's dry run builds the VLM's round
   (``make_round_step(bundle.loss_fn, plan, seed)``: the VLM has no
   federated task) on a seeded round batch in ``vlm_train_batch``'s layout
   at train_4k (576 image tokens of 1,024 and 3,520 text tokens a row, K=4,
   b=1, 2 local steps, FVN 0.01, the server's Adam at 1e-5): two rounds
   with exact launches a client step (K10's forward 4 on <2, 128> and its
   backward 4 on <2, 2>, the normal kernel 1), round times, peak memory, a
   profiled round; the first client step's loss, one forward on K10 and
   one on its plain version, within LLAVA_LOSS_RTOL, and that forward's
   logits at every position within QWEN_SERVE_TOL; then served as
   qwen3-8b is (_serve_transformer): B=4 rows of 576 image tokens and a
   128-token prompt,
   prefill over 704 positions (K10 4), the cache grown to 736 slots, 32
   greedy decode steps of text (K11 4 each), each step's logits held to a
   teacher-forced forward within QWEN_SERVE_TOL;
6. one more round of each uncompressed configuration on its own under
   ``torch.profiler``: the device's busy share of a round and the
   kernels that fill it; and one more K2 round with the host's Python
   calls traced (``with_stack=True``): the host time under each of the
   port's functions (the sampler, the copy to the card, the clients' loss
   forward, ``torch.autograd.grad``, local optimizer and FVN, the server
   stage);
7. the tuner's LSTM autotune at the paper's width, not kept.

The line before the last is a JSON object listing every kernel; the
last is ``{"ok": true, "device": {...}}``. A failed phase raises, and
the script exits non-zero. It refuses to run without a CUDA card or
outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense fp32 rate (CUDA cores)
# and dense bf16 rate (tensor cores, fp32 accumulation)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# exponentials on the special-function units: 16 a clock on each of 132 SMs,
# about 3.9 T/s (FlashAttention-3, arXiv:2407.08608, section 3)
SFU_OPS_PER_S = 3.9e12
# 32-bit integer operations (add, xor, shift), not in the data sheet: the
# Hopper white paper's 64 INT32 lanes per SM, 132 SMs, at the 1.98 GHz that
# the fp32 rate above implies (67e12 / (132 * 128 * 2))
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# the keyed draw's 32-bit integer operations, counted in csrc/wire_pack.cu
# as the function needs them: a size-n draw hashes ceil(n/2) threefry2x32
# blocks, block (pair, pair + half) serving position pair with its first
# word and position pair + half with its second. A block is 2 counter adds,
# 20 rounds of add, rotate (one funnel shift) and xor, 5 key injections of
# 2 adds, and 3 for its second counter (add, compare, select); each element
# then takes 2 for its mantissa fill (shift, or). The kernel hashes every
# block twice, once for each position it serves: the bound does not.
WIRE_BLOCK_INT_OPS = 75
WIRE_ELEM_INT_OPS = 2
# the quantizer's fp32 operations per element: the division, clamp and
# rounding
WIRE_QUANT_FP_OPS = 8
# the normal kernel's fp32 operations, counted in csrc/threefry_normal.cu
# with a fused multiply-add as 2: one branch of XLA's CPU log1p a draw,
# Cephes's 30 where |y| < sqrt(2) - 1 and Eigen's log 36 elsewhere
# (counted from the run's draws), and for every element the erf_inv
# polynomial's common branch 20, the fill and the uniform 5, the scaled
# sum 2. Its int32 operations are K5's: a threefry block a pair of
# elements and the fill's 2 an element.
NORMAL_CEPHES_FP_OPS = 30
NORMAL_EIGEN_FP_OPS = 36
NORMAL_ELEM_FP_OPS = 27

# gate operations per hidden unit, counted in csrc/lstm_gates.cu
# (a sigmoid is 4, a tanh 1)
FWD_OPS_PER_UNIT = 19
BWD_OPS_PER_UNIT = 40

# K3/K4 against their plain versions. Log-probs in fp32: a J-term dot
# product and a V-term log-sum-exp summed in another order, |log p| ~ 10.
JOINT_FWD_ATOL = 1e-4
# Gradients in fp32, relative to each gradient's largest entry: sums of
# V products (dh) and of B·T·U1 products (dW, db) in another order.
JOINT_BWD_REL_TOL = 1e-4
# K3/K4's shapes: the paper-width client step, a ragged small shape, a J
# that is not a multiple of 4, the fedsgd round's one step over the
# K·S·b = 32 examples of a paper-width round, and the per-client panel's
# forward over its C·n = 6·4 = 24 examples (B, T, U1, J, V, e and g's
# dtype name); the kernels line's rows are the first shape's
JOINT_SHAPES = ((4, 64, 33, 640, 4096, "bfloat16"), (3, 24, 13, 64, 64, "float32"),
                (2, 16, 9, 30, 200, "float32"), (32, 64, 33, 640, 4096, "bfloat16"),
                (24, 64, 33, 640, 4096, "bfloat16"))

# K2 against its plain versions, all with bf16 xg and fp32 w_hh. ys in
# bf16: both carry h in fp32, with the 1152-term sums in another order,
# and may round it to neighbouring bf16 values, one bf16 ulp apart (2**-8
# for |h| < 1). cs in fp32 after up to 64 steps: 1e-4.
SCAN_YS_ATOL = 2.0 ** -8
SCAN_CS_ATOL = 1e-4
# The backward recurrence and the dw product in fp32, both sides fed the
# same saved (ys, cs) so that a bf16 flip does not compound: relative to
# each gradient's largest entry, sums of 4H (dh) and S·B (dw) products.
SCAN_BWD_REL_TOL = 1e-4
# The paper-width round's first loss on the K2 path against the time
# loop's, from the same seed: the time loop rounds h to bf16 every step,
# K2 carries it in fp32 (as the JAX package's two paths do).
SCAN_LOSS_RTOL = 5e-3
# the K2 round's losses (K2 with K3/K4, rounds 1 and 2, FVN's noise on
# JAX's threefry normal): every redesign of a kernel keeps them bit for bit
K2_ROUND_LOSSES = (22.00799560546875, 22.067508697509766)

# the paper-width round of phases 5 and 6: K=4 clients, b=4, 2 local
# steps, FVN std 0.01; phase 5 ends with the final evaluation on 64
# examples of each split
PAPER_ARGV = ["--preset", "arch", "--clients", "4", "--batch", "4", "--data-limit", "8",
              "--fvn-std", "0.01", "--eval-every", "0"]
EVAL_EXAMPLES = 64

# the compressed paper-width runs of phases 5 and 6: (name, CLI flags, the
# CompressionConfig they give; nearest rounding has no flag), each with the
# exact uplink bytes per client of rnnt-librispeech's 35 tensors
COMPRESSED = (
    ("int4_packed", ["--compression", "int4", "--packed-wire"],
     dict(kind="int4", packed=True), 52_667_020),
    ("int4_packed_ef", ["--compression", "int4", "--packed-wire", "--error-feedback"],
     dict(kind="int4", packed=True, error_feedback=True), 52_667_020),
    ("topk5_ef", ["--compression", "topk", "--topk-frac", "0.05", "--error-feedback"],
     dict(kind="topk", topk_frac=0.05, error_feedback=True), 42_133_592),
    ("int8_nearest", ["--compression", "int8"], dict(kind="int8", stochastic=False),
     105_333_900),
)
# the compression kernels each compressed run launches once per leaf per round
WIRE_LAUNCHES = {
    "int4_packed": ("wire_quantize", "nibble_unpack"),
    "int4_packed_ef": ("wire_quantize", "nibble_pack", "nibble_unpack"),
    "topk5_ef": ("topk_scatter_add", "topk_scatter_add_sort", "topk_scatter_add_sum"),
    "int8_nearest": ("wire_quantize",),
}
# the slow path's paper-width runs (a robust aggregator or a delta
# adversary): (name, CLI flags, the exact uplink bytes per reporting
# client, the plane kernels it launches once per leaf per round)
SLOWPATH = (
    ("int4_packed_trimmed_signflip_p75",
     ["--compression", "int4", "--packed-wire", "--aggregator", "trimmed_mean", "--trim-frac",
      "0.25", "--corrupt-kind", "sign_flip", "--corrupt-rate", "0.25", "--corrupt-scale", "3",
      "--participation", "0.75"], 52_667_020, ("wire_quantize", "nibble_unpack", "dequantize")),
    ("int4_graph_trimmed_signflip_p75",
     ["--compression", "int4", "--aggregator", "trimmed_mean", "--trim-frac", "0.25",
      "--corrupt-kind", "sign_flip", "--corrupt-rate", "0.25", "--corrupt-scale", "3",
      "--participation", "0.75"], 52_667_020, ("wire_quantize",)),
    ("topk5_packed_median_stale_stragglers",
     ["--compression", "topk", "--topk-frac", "0.05", "--packed-wire", "--aggregator",
      "coordinate_median", "--corrupt-kind", "stale", "--corrupt-rate", "0.5",
      "--corrupt-scale", "1", "--straggler-frac", "0.5", "--straggler-keep", "0.5"],
     42_133_592, ("topk_unpack",)),
    ("fp32_clipped_dp_gaussian_latency",
     ["--aggregator", "clipped_mean", "--dp-clip", "1.0", "--dp-sigma", "0.01",
      "--corrupt-kind", "gaussian", "--corrupt-rate", "0.25", "--corrupt-scale", "5",
      "--latency"], 421_335_040, ()),
)
# the slow-path planes whose draws go through the normal kernel (the same
# draws on both devices, but the scales' fp32 sums of squares in another
# order on the card): held cuda against cpu at this tolerance, the others
# bit for bit
SLOW_NORMAL_TOL = 1e-5
WIRE_KERNELS = ("wire_quantize", "nibble_pack", "nibble_unpack", "dequantize",
                "topk_scatter_add", "topk_scatter_add_sort", "topk_scatter_add_sum",
                "topk_unpack")
N_LEAVES = 35
# the joint's kernels (K3's calls and its three launches, then K4's five),
# each launched once a client step on use_kernel=True
JOINT_KERNELS = ("rnnt_joint_fwd", "rnnt_joint_fwd_h", "rnnt_joint_fwd_logits",
                 "rnnt_joint_fwd_lse", "rnnt_joint_bwd_h", "rnnt_joint_bwd_dlogits",
                 "rnnt_joint_bwd_dh", "rnnt_joint_bwd_reduce", "rnnt_joint_bwd_dw")


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card(torch) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[card] set torch.backends.cuda.matmul.allow_tf32 = False and "
        "torch.backends.cudnn.allow_tf32 = False")


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    log(f"[build] {len(build.SOURCES)} source(s) ready in {time.perf_counter() - t0:.2f} s "
        f"({len(logs)} compiled now) under {build.BUILD_DIR}")
    for name, text in logs.items():
        entry = "?"  # the kernel ptxas reports on, with its template arguments
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
                # past an anonymous namespace's prefix (<8 hex digits><length>)
                m = re.search(r"_cu_[0-9a-f]{8}(\d+)", entry)
                if m:
                    entry = entry[m.end():m.end() + int(m.group(1)) + 24]
            elif "spill" in line or ("ptxas info" in line and "Used" in line):
                log(f"[build] {name}: {entry[:72]}: {line.strip()}")


def cuda_ms(torch, fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` back-to-back calls
    on the current stream, after a warm-up (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(torch, fn, n: int) -> float:
    """Mean milliseconds per call of ``fn`` replayed from one CUDA graph
    of ``n`` calls: the device's time, without the host's cost of
    issuing each launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * n)


def _bound(nbytes: int, ops: int, bf16_ops: int = 0, exps: int = 0):
    """(ms, what bounds it): ``ops`` at the fp32 rate, ``bf16_ops`` (the
    products of two bf16 operands, exact in a bf16 MMA with fp32
    accumulation) at the bf16 tensor rate; ``exps`` exponentials on the
    special-function units, which run beside the tensor cores (the larger
    of the two counts)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / FP32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S, exps / SFU_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _us(ms) -> str:
    return "n/a" if ms is None else f"{ms * 1e3:.2f}"


def _ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}"


def _max_err(torch, got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def _assert_close(torch, got, want, gate_dtype, what):
    """Outputs in the gate dtype at that dtype's tolerance; fp32 outputs
    (the cell state and its gradient) at fp32's."""
    tol = {torch.float32: dict(rtol=0.0, atol=1e-5),
           torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}  # one bf16 ulp at |x| <= 2
    for g, w in zip(got, want):
        t = tol[gate_dtype] if g.dtype == gate_dtype else tol[torch.float32]
        torch.testing.assert_close(g.float(), w.float(), **t, msg=lambda m: f"{what}: {m}")


def phase_kernels(torch):
    """K1 forward and backward against the plain version at the full-width
    training step (N=4, H=1152), a larger batch (N=32), the decoding batch
    (N=64), the per-client panel's decoding batch (N=24) and a ragged H
    (N=5, H=96), in bf16 and fp32 gates. Returns
    {kernel: row at the training path's shape}."""
    from repro_torch.kernels import lstm_gates as K
    from repro_torch.kernels import ref

    aten = torch.ops.aten
    has_lib = hasattr(aten, "_thnn_fused_lstm_cell")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _k1_refusals(torch)
    rows = {}
    for N, H in ((4, 1152), (32, 1152), (64, 1152), (24, 1152), (5, 96)):
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape, dt=torch.float32, scale=1.0):
                return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dt)

            gates, c = rnd(N, 4 * H, dt=dtype, scale=2.0), rnd(N, H)
            dh, dcn = rnd(N, H, dt=dtype), rnd(N, H)
            got_f = K.lstm_gates_fwd(gates, c)
            got_b = K.lstm_gates_bwd(gates, c, dh, dcn)
            torch.cuda.synchronize()
            want_f = ref.lstm_gates_ref(gates, c)
            want_b = ref.lstm_gates_bwd_ref(gates, c, dh, dcn)
            tag = f"N={N} H={H} {str(dtype).split('.')[1]}"
            _assert_close(torch, got_f, want_f, dtype, f"lstm_gates_fwd {tag}")
            _assert_close(torch, got_b, want_b, dtype, f"lstm_gates_bwd {tag}")
            if got_f[0].dtype != dtype or got_f[1].dtype != torch.float32 or \
                    got_b[0].dtype != dtype or got_b[1].dtype != torch.float32:
                raise AssertionError(f"{tag}: the kernels broke the dtype contract")

            # each input read once, each output written once
            gs = gates.element_size()
            fwd_bytes = N * 4 * H * gs + N * H * 4 + N * H * gs + N * H * 4
            bwd_bytes = 2 * N * 4 * H * gs + 3 * N * H * 4 + N * H * gs
            lib_f = lib_b = None  # one PyTorch call of the same function, a yardstick only
            if has_lib:
                hb = torch.zeros(4 * H, dtype=dtype, device="cuda")
                hb[H:2 * H] = 1.0  # the +1 forget-gate bias
                ib, zg, cc, dcn_l = torch.zeros_like(hb), torch.zeros_like(gates), \
                    c.to(dtype), dcn.to(dtype)
                try:
                    hy, cy, ws = aten._thnn_fused_lstm_cell(gates, zg, cc, ib, hb)
                except RuntimeError as e:
                    log(f"[kernels] {tag}: library fused cell unavailable: {e}")
                else:
                    log(f"[kernels] {tag}: library fused cell agrees to "
                        f"{_max_err(torch, (hy, cy), want_f):.2e}")

                    def lib_f():
                        return aten._thnn_fused_lstm_cell(gates, zg, cc, ib, hb)

                    def lib_b():
                        return aten._thnn_fused_lstm_cell_backward_impl(
                            dh, dcn_l, cc, cy, ws, True)
            def no_grad_cell():  # timed inside one no_grad block, as the evaluation calls it
                return K.lstm_gates(gates, c)

            for name, kernel, plain, lib, nbytes, ops, err in (
                ("lstm_gates_fwd", lambda: K.lstm_gates_fwd(gates, c),
                 lambda: ref.lstm_gates_ref(gates, c), lib_f, fwd_bytes,
                 FWD_OPS_PER_UNIT * N * H, _max_err(torch, got_f, want_f)),
                ("lstm_gates_bwd", lambda: K.lstm_gates_bwd(gates, c, dh, dcn),
                 lambda: ref.lstm_gates_bwd_ref(gates, c, dh, dcn), lib_b, bwd_bytes,
                 BWD_OPS_PER_UNIT * N * H, _max_err(torch, got_b, want_b)),
            ):
                # the forward also as the evaluation calls it: lstm_gates
                # under no_grad, the same launch path without the Function
                with torch.no_grad():  # no input requires grad: only lstm_gates notices
                    t = {what: (cuda_ms(torch, fn, 1000), graph_ms(torch, fn, 200))
                         for what, fn in (("kernel", kernel),
                                          ("no_grad lstm_gates",
                                           no_grad_cell if name == "lstm_gates_fwd" else None),
                                          ("plain", plain), ("library", lib))
                         if fn is not None}
                t.setdefault("library", (None, None))
                bound_ms, bound_by = _bound(nbytes, ops)
                log(f"[kernels] {name} {tag}: max|err| {err:.2e}; us per call eager/graph: "
                    + ", ".join(f"{w} {_us(e)}/{_us(g)}" for w, (e, g) in t.items())
                    + f"; bound {bound_ms * 1e6:.1f} ns ({bound_by}, {nbytes} B)")
                if t["library"][0] is not None:
                    eager = ", ".join(f"{w} {t[w][0] / t['library'][0]:.2f}x" for w in
                                      ("kernel", "no_grad lstm_gates") if w in t)
                    log(f"[kernels] {name} {tag}: eager time / the library's eager time: "
                        f"{eager}; graph time {_us(t['kernel'][1])} us")
                if (N, H, dtype) == (4, 1152, torch.bfloat16):
                    rows[name] = {"max_abs_err": err, "ms": t["kernel"][0],
                                  "plain_ms": t["plain"][0], "bound_ms": bound_ms,
                                  "bound_by": bound_by, "library_ms": t["library"][0]}
            if dtype == torch.bfloat16:
                _k1_host_breakdown(torch, gates, c, lib_f, tag)
    return rows


# host calls per item of the K1 launch path's breakdown
K1_HOST_CALLS = 10_000


def _k1_host_breakdown(torch, gates, c, lib_f, tag: str) -> None:
    """What each piece of K1's launch path costs on the host, in us per
    call (time.perf_counter_ns over K1_HOST_CALLS calls, then a
    synchronize): the raw stream handle, the operator call (validation,
    allocations and launch in C++), the path whole (``lstm_gates_fwd``,
    and ``lstm_gates`` under no_grad), ``LSTMGatesFn.apply`` around it
    (the path with grad on) and the library's fused cell."""
    from repro_torch.kernels import lstm_gates as K

    K.lstm_gates_fwd(gates, c)  # binds the operators
    device, index = gates.device, gates.get_device()
    getter = K._Ops.stream
    stream = getter(index)
    if stream != torch.cuda.current_stream(device).cuda_stream:
        raise AssertionError("the raw stream handle is not the current stream's")
    op = K._Ops.fwd
    items = (
        ("raw stream", lambda: getter(index)),
        ("operator call", lambda: op(gates, c, stream)),
        ("lstm_gates_fwd", lambda: K.lstm_gates_fwd(gates, c)),
        ("lstm_gates under no_grad", lambda: K.lstm_gates(gates, c)),
        ("LSTMGatesFn.apply", lambda: K.LSTMGatesFn.apply(gates, c)),
        ("library fused cell", lib_f),
    )
    out = []
    for what, fn in items:
        if fn is None:
            continue
        # each item in one no_grad block (the evaluation's decode runs in
        # one); none of the inputs requires grad, so only lstm_gates
        # takes another path for it
        with torch.no_grad():
            for _ in range(100):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(K1_HOST_CALLS):
                fn()
            torch.cuda.synchronize()
        out.append(f"{what} {(time.perf_counter_ns() - t0) / K1_HOST_CALLS / 1e3:.2f}")
    log(f"[kernels] lstm_gates host breakdown {tag}, us per call on the host: " + "; ".join(out))


def _k1_refusals(torch) -> None:
    """Every refusal of K1's ``_check`` on the card: the wrappers raise the
    same exception type as ``_check`` on the same inputs (the operators
    make the refusals for tensors on CUDA)."""
    from repro_torch.kernels import lstm_gates as K

    def z(*shape, dtype=torch.float32, device="cuda"):
        return torch.zeros(shape, dtype=dtype, device=device)

    g, c = z(2, 8), z(2, 2)
    cases = {
        "gates (2, 7)": (z(2, 7), c), "gates 1-d": (z(8), c), "c (2, 3)": (g, z(2, 3)),
        "c on the CPU": (g, z(2, 2, device="cpu")), "c on meta": (g, z(2, 2, device="meta")),
        "float16 gates": (z(2, 8, dtype=torch.float16), c),
        "bfloat16 c": (g, z(2, 2, dtype=torch.bfloat16)),
        "gates not contiguous": (z(8, 2).t(), c), "N = 0": (z(0, 8), z(0, 2)),
        "dh bfloat16": (g, c, z(2, 2, dtype=torch.bfloat16), c),
        "dc_next (3, 2)": (g, c, c, z(3, 2)), "dc_next on the CPU": (g, c, c, z(2, 2, device="cpu")),
        "dh not contiguous": (g, c, z(2, 2).t(), c),
    }

    def raised(fn, args):
        try:
            fn(*args)
        except (ValueError, TypeError) as e:
            return type(e)
        return None

    for what, args in cases.items():
        want = raised(K._check, args)
        got = raised(K.lstm_gates_fwd if len(args) == 2 else K.lstm_gates_bwd, args)
        if want is None or got is not want:
            raise AssertionError(f"lstm_gates {what}: the wrapper raised {got}, _check {want}")
    torch.cuda.synchronize()
    log(f"[kernels] lstm_gates: {len(cases)} refusals on the card raise _check's exception types")


def phase_joint_kernels(torch):
    """K3 and K4 against their plain versions at the paper-width client
    step (B=4, T'=64, U1=33, J=640, V=4096; bf16 e and g, fp32 W and b),
    at a ragged small shape (B=3, T=24, U1=13, J=64, V=64, fp32), at a
    J that is not a multiple of 4 (B=2, T=16, U1=9, J=30, V=200, fp32)
    and at the fedsgd round's shape (B=32, the paper's T', U1, J, V):
    the whole forward and backward, then each of K3's three launches and
    K4's five alone on the same inputs as its plain version. The forward
    and the backward run twice and must give the same bits, and the
    forward is replayed twice from one CUDA graph for them too. Each launch
    is timed beside its bound, its plain version and, for the products, the
    same run's fp32 ``torch.matmul`` of its product (TF32 off), a
    yardstick. Returns {kernel: row at the paper-width shape}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rnnt_joint as K

    gen = torch.Generator(device="cuda").manual_seed(1)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def rel(got, want) -> float:
        return max(float((x - y).abs().max()) / (float(y.abs().max()) + 1e-30)
                   for x, y in zip(got, want))

    rows = {}
    for B, T, U1, J, V, dname in JOINT_SHAPES:
        dtype = getattr(torch, dname)
        tag = f"B={B} T={T} U1={U1} J={J} V={V} {dname}" + {32: " (fedsgd)", 24: " (panel)"}.get(B, "")
        inputs = (rnd(B, T, J, scale=0.5).to(dtype), rnd(B, U1, J, scale=0.5).to(dtype),
                  rnd(J, V, scale=J ** -0.5), rnd(V, scale=0.1),
                  torch.randint(0, V, (B, U1), generator=gen, device="cuda",
                                dtype=torch.int32))
        got_f = K.rnnt_joint_fwd(*inputs)
        _check_joint_fwd_bits(torch, K, inputs, got_f, tag)
        bwd_args = (*inputs, got_f[2], rnd(B, T, U1), rnd(B, T, U1))
        got_b = K.rnnt_joint_bwd(*bwd_args)
        again = K.rnnt_joint_bwd(*bwd_args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got_b, again)):
            raise AssertionError(f"rnnt_joint_bwd {tag}: two runs on the same inputs differ")
        want_f = ref.rnnt_joint_fwd_ref(*inputs)
        want_b = ref.rnnt_joint_bwd_ref(*bwd_args)
        err_f = _max_err(torch, got_f, want_f)
        if err_f > JOINT_FWD_ATOL:
            raise AssertionError(f"rnnt_joint_fwd {tag}: max|err| {err_f:.2e} > {JOINT_FWD_ATOL}")
        rel_b = {name: rel((x,), (y,)) for name, x, y in zip(("de", "dg", "dw", "db"), got_b,
                                                              want_b)}
        if max(rel_b.values()) > JOINT_BWD_REL_TOL:
            raise AssertionError(f"rnnt_joint_bwd {tag}: error relative to max {rel_b} > "
                                 f"{JOINT_BWD_REL_TOL}")
        log(f"[kernels] rnnt_joint {tag}: fwd max|err| {err_f:.2e} (tol {JOINT_FWD_ATOL}); "
            f"bwd |err|/max " + ", ".join(f"{k} {v:.2e}" for k, v in rel_b.items())
            + f" (tol {JOINT_BWD_REL_TOL}); forward (twice, and two replays of one CUDA "
            "graph) and backward bitwise repeatable")
        # K3's three launches and the backward's five one by one, each on
        # the kernel's input before it, held to its plain version on that
        # input
        e, g, w, b, labels, lse, dbl, dlb = bwd_args
        hf = K._fwd_h(e, g, U1)
        logits = K._fwd_logits(hf, w, b)
        h = K._bwd_h(e, g, U1)
        dlogits, dh_fix = K._bwd_dlogits(h, w, b, labels, lse, dbl, dlb)
        dpre = K._bwd_dh(dlogits, dh_fix, labels, w, h)
        # dh's operand at v=0 and at the label (the design before rounded
        # them otherwise for dh): the same cotangents to the tolerance
        at = torch.stack([dlogits[..., 0], dlogits.gather(
            -1, labels[:, None, :, None].long().expand(B, T, U1, 1))[..., 0]], dim=-1)
        r_fix = rel((dh_fix,), (at,))
        if r_fix > JOINT_BWD_REL_TOL:
            raise AssertionError(f"rnnt_joint_bwd_dlogits {tag}: dh's operand at v=0 and at "
                                 f"the label, error relative to max {r_fix:.2e}")
        N = B * T * U1
        h2, d2 = h.reshape(N, J), dlogits.reshape(N, V)
        in_bytes = (B * T * J + B * U1 * J) * e.element_size()
        lattice, hb, db_, wb = N * 4, N * J * 4, N * V * 4, J * V * 4
        # (name, kernel, plain, the fp32 product of a products' launch or
        # None, bytes, operations, exponentials)
        launches = (
            ("rnnt_joint_fwd", lambda: K.rnnt_joint_fwd(*inputs),
             lambda: ref.rnnt_joint_fwd_ref(*inputs), lambda: torch.matmul(h2, w),
             in_bytes + wb + V * 4 + B * U1 * 4 + 3 * lattice, 2 * N * J * V, 0),
            ("rnnt_joint_fwd_h", lambda: K._fwd_h(e, g, U1),
             lambda: ref.rnnt_joint_h_ref(e, g), None, in_bytes + hb, N * J, 0),
            ("rnnt_joint_fwd_logits", lambda: K._fwd_logits(hf, w, b),
             lambda: ref.rnnt_joint_logits_ref(hf, w, b), lambda: torch.matmul(h2, w),
             hb + wb + V * 4 + db_, 2 * N * J * V, 0),
            ("rnnt_joint_fwd_lse", lambda: K._fwd_lse(logits, labels),
             lambda: ref.rnnt_joint_lse_ref(logits, labels), None,
             db_ + B * U1 * 4 + 3 * lattice, 0, N * V),
            ("rnnt_joint_bwd_h", lambda: K._bwd_h(e, g, U1),
             lambda: ref.rnnt_joint_h_ref(e, g), None, in_bytes + hb, N * J, 0),
            ("rnnt_joint_bwd_dlogits",
             lambda: K._bwd_dlogits(h, w, b, labels, lse, dbl, dlb)[0],
             lambda: ref.rnnt_joint_dlogits_ref(h, w, b, labels, lse, dbl, dlb),
             lambda: torch.matmul(h2, w), hb + wb + V * 4 + B * U1 * 4 + 3 * lattice + db_,
             2 * N * J * V, 0),
            ("rnnt_joint_bwd_dh", lambda: K._bwd_dh(dlogits, dh_fix, labels, w, h),
             lambda: ref.rnnt_joint_dpre_ref(dlogits, w, h), lambda: torch.matmul(d2, w.T),
             db_ + wb + 2 * hb, 2 * N * J * V, 0),
            ("rnnt_joint_bwd_reduce", lambda: K._bwd_reduce(dpre),
             lambda: ref.rnnt_joint_bwd_reduce_ref(dpre), None,
             (N + B * T + B * U1) * J * 4, 2 * N * J, 0),
            ("rnnt_joint_bwd_dw", lambda: K._bwd_dw(h, dlogits),
             lambda: ref.rnnt_joint_dw_ref(h, dlogits), lambda: torch.matmul(h2.T, d2),
             hb + db_ + wb + V * 4, 2 * N * J * V, 0),
        )
        errs = {"rnnt_joint_fwd": err_f}
        for name, kernel, plain, _, _, _, _ in launches[1:]:
            got, want = kernel(), plain()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            torch.cuda.synchronize()
            errs[name] = _max_err(torch, got, want)
            if name.startswith("rnnt_joint_fwd"):  # log-probs and logits: absolute
                if errs[name] > JOINT_FWD_ATOL:
                    raise AssertionError(f"{name} {tag}: max|err| {errs[name]:.2e} > "
                                         f"{JOINT_FWD_ATOL}")
                log(f"[kernels] {name} {tag}: max|err| {errs[name]:.2e} (tol {JOINT_FWD_ATOL})")
                continue
            r = rel(got, want)
            if r > JOINT_BWD_REL_TOL:
                raise AssertionError(f"{name} {tag}: error relative to max {r:.2e} > "
                                     f"{JOINT_BWD_REL_TOL}")
            log(f"[kernels] {name} {tag}: |err|/max {r:.2e} (tol {JOINT_BWD_REL_TOL})"
                + (f"; dh's operand at v=0 and the label {r_fix:.2e}"
                   if name == "rnnt_joint_bwd_dlogits" else ""))

        n_eager, n_graph = (20, 10) if N * J * V > 10**9 else (200, 100)
        whole = {what: (cuda_ms(torch, fn, n_eager), graph_ms(torch, fn, n_graph))
                 for what, fn in (("kernels", lambda: K.rnnt_joint_bwd(*bwd_args)),
                                  ("plain", lambda: ref.rnnt_joint_bwd_ref(*bwd_args)))}
        bound_ms, bound_by = _bound(in_bytes + wb + V * 4 + B * U1 * 4 + 3 * lattice
                                    + (B * T * J + B * U1 * J + J * V + V) * 4, 6 * N * J * V)
        log(f"[kernels] rnnt_joint_bwd {tag}, the whole backward (5 launches; scratch h "
            f"{hb} B, dlogits {db_} B, dh_fix {lattice * 2} B): ms per call eager/graph: "
            + ", ".join(f"{w_} {e_:.3f}/{g_:.3f}" for w_, (e_, g_) in whole.items())
            + f"; bound {bound_ms:.3f} ms ({bound_by}, {6 * N * J * V} flop)")
        for name, kernel, plain, product, nbytes, ops, exps in launches:
            t = {what: (cuda_ms(torch, fn, n_eager), graph_ms(torch, fn, n_graph))
                 for what, fn in (("kernel", kernel), ("plain", plain),
                                  ("torch.matmul", product)) if fn is not None}
            t.setdefault("torch.matmul", (None, None))
            bound_ms, bound_by = _bound(nbytes, ops, exps=exps)
            log(f"[kernels] {name} {tag}: max|err| {errs[name]:.2e}; us per call eager/graph: "
                + ", ".join(f"{w_} {_us(e_)}/{_us(g_)}" for w_, (e_, g_) in t.items())
                + f"; bound {bound_ms * 1e3:.2f} us ({bound_by}, {ops} flop, {exps} exp, "
                f"{nbytes} B); "
                f"graph time / bound {t['kernel'][1] / bound_ms:.2f}"
                + (f", eager time / torch.matmul's {t['kernel'][0] / t['torch.matmul'][0]:.2f}"
                   if product is not None else ""))
            if (B, T, U1, J, V, dname) == JOINT_SHAPES[0]:
                rows[name] = {"max_abs_err": errs[name], "ms": t["kernel"][0],
                              "plain_ms": t["plain"][0], "bound_ms": bound_ms,
                              "bound_by": bound_by, "library_ms": t["torch.matmul"][0]}
        del h, dlogits, dh_fix, dpre, h2, d2, hf, logits
    return rows


def _check_joint_fwd_bits(torch, K, inputs, got, tag: str) -> None:
    """K3 a second time, and replayed twice from one CUDA graph: the
    first call's bits each time."""
    runs = [K.rnnt_joint_fwd(*inputs), *_graph_outputs(torch, lambda: K.rnnt_joint_fwd(*inputs))]
    for what, outs in zip(("a second call", "replay 1", "replay 2"), runs):
        if not all(torch.equal(x, y) for x, y in zip(outs, got)):
            raise AssertionError(f"rnnt_joint_fwd {tag}: {what} differs from the first call")


def _rel_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) / (float(w.float().abs().max()) + 1e-30)
               for g, w in zip(got, want))


# K2's shapes: the paper's encoder layer (S=T'=64) and predictor layer
# (S=U+1=33) in a client step of b=4, the encoder over the 64 examples of
# one decode, a ragged small shape, the encoder and predictor layers of
# the fedsgd round's one step over the K·S·b = 32 examples of a round, and
# those of the per-client panel's forward over its C·n = 24 examples
SCAN_SHAPES = (("encoder", 64, 4, 1152), ("predictor", 33, 4, 1152),
               ("decode", 64, 64, 1152), ("ragged", 17, 3, 96),
               ("fedsgd encoder", 64, 32, 1152), ("fedsgd predictor", 33, 32, 1152),
               ("panel encoder", 64, 24, 1152), ("panel predictor", 33, 24, 1152))
# the backward recurrence's other routes: B=5 and B=8 stage 8 rows at a
# time (BB=8), and H=1153 leaves the last block of 9 units one unit
SCAN_BWD_SHAPES = (("B=5", 17, 5, 1152), ("B=8", 17, 8, 1152), ("partial block", 17, 4, 1153))


def _graph_outputs(torch, fn, replays: int = 2):
    """The outputs of ``fn`` (a tensor or a tuple of them) after each of
    ``replays`` replays of one CUDA graph that captured one call, zeroed
    before each replay and cloned after it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out = out if isinstance(out, (tuple, list)) else (out,)
    got = []
    for _ in range(replays):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        got.append([o.clone() for o in out])
    return got


def _check_scan_bwd(torch, K, ref, args, tag: str) -> tuple:
    """The backward recurrence on ``args`` twice and from two replays of
    one CUDA graph, all with the same bits, held to its plain version.
    Returns (outputs, |err|/max, max|err|)."""
    got, again = K.lstm_scan_bwd_rec(*args), K.lstm_scan_bwd_rec(*args)
    replays = _graph_outputs(torch, lambda: K.lstm_scan_bwd_rec(*args))
    torch.cuda.synchronize()
    for other, what in ((again, "two launches"), *((r, f"graph replay {i + 1}")
                                                   for i, r in enumerate(replays))):
        if not all(torch.equal(x, y) for x, y in zip(got, other)):
            raise AssertionError(f"lstm_scan_bwd {tag}: {what} on the same inputs differ")
    want = ref.lstm_scan_bwd_rec_ref(*args)
    rel = _rel_err(got, want)
    if rel > SCAN_BWD_REL_TOL:
        raise AssertionError(f"lstm_scan_bwd {tag}: error relative to max {rel:.2e} > "
                             f"{SCAN_BWD_REL_TOL}")
    return got, rel, _max_err(torch, got, want)


def _log_scan_bwd_phases(torch, K, args, got, tag: str) -> None:
    """The backward with its recurrence's timed instantiation on ``args``:
    the same bits as the model's, the gate recompute's and the
    recurrence's ms (CUDA events), and the recurrence's us a step in each
    phase, the mean over the blocks and the slowest block; the prologue
    and epilogue in us a launch."""
    K.lstm_scan_bwd_phases(*args)  # the timed kernel's first launch loads it: not timed
    out, gates_ms, rec_ms, times = K.lstm_scan_bwd_phases(*args)
    if not all(torch.equal(x, y) for x, y in zip(out, got)):
        raise AssertionError(f"lstm_scan_bwd {tag}: the timed instantiation's bits differ")
    S = times.shape[1] - 1
    us = times.double() / 1e3
    per_step = us[:, :S].sum(dim=1) / S  # (blocks, phases)
    parts = []
    for i, phase in enumerate(K.BWD_PHASES):
        once = phase in ("prologue", "epilogue")
        col = us[:, S, i] if once else per_step[:, i]
        parts.append(f"{phase} {float(col.mean()):.3f} (slowest block {float(col.max()):.3f}) "
                     + ("us a launch" if once else "us a step"))
    steps = sum(per_step[:, i] for i, phase in enumerate(K.BWD_PHASES)
                if phase not in ("prologue", "epilogue"))
    log(f"[kernels] lstm_scan_bwd {tag}: gate recompute {gates_ms * 1e3:.1f} us, recurrence "
        f"{rec_ms * 1e3:.1f} us (timed, CUDA events); the recurrence's phases "
        f"({times.shape[0]} blocks, thread 0's %globaltimer): " + "; ".join(parts)
        + f"; all steps' phases {float(steps.mean()):.3f} (slowest block "
        f"{float(steps.max()):.3f}) us a step")


def _log_scan_fwd_phases(torch, K, args, got, tag: str) -> None:
    """The forward's timed instantiation on ``args``: the same bits as the
    model's, its ms (CUDA events), and its us a step in each phase, the
    mean over the blocks and the slowest block; the prologue in us a
    launch."""
    K.lstm_scan_fwd_phases(*args)  # the timed kernel's first launch loads it: not timed
    out, ms, times = K.lstm_scan_fwd_phases(*args)
    if not all(torch.equal(x, y) for x, y in zip(out, got)):
        raise AssertionError(f"lstm_scan_fwd {tag}: the timed instantiation's bits differ")
    S = times.shape[1] - 1
    us = times.double() / 1e3
    per_step = us[:, :S].sum(dim=1) / S  # (blocks, phases)
    parts = []
    for i, phase in enumerate(K.FWD_PHASES):
        col = us[:, S, i] if phase == "prologue" else per_step[:, i]
        parts.append(f"{phase} {float(col.mean()):.3f} (slowest block {float(col.max()):.3f}) "
                     + ("us a launch" if phase == "prologue" else "us a step"))
    steps = sum(per_step[:, i] for i, phase in enumerate(K.FWD_PHASES) if phase != "prologue")
    log(f"[kernels] lstm_scan_fwd {tag}: {ms * 1e3:.1f} us (timed, CUDA events); its phases "
        f"({times.shape[0]} blocks, thread 0's %globaltimer): " + "; ".join(parts)
        + f"; all steps' phases {float(steps.mean()):.3f} (slowest block "
        f"{float(steps.max()):.3f}) us a step")


def phase_scan_kernels(torch, timing: bool = True):
    """K2's three kernels against their plain versions at SCAN_SHAPES,
    bf16 xg and fp32 w_hh: the forward, then (but for decoding, which has
    no backward) the backward recurrence and the dw product on the same
    saved tensors, each run twice and held to the same bits. With
    ``timing``, each kernel's time, eager and from a CUDA graph, beside
    its bound, its plain version and a library yardstick. Returns
    {kernel: row at the encoder shape}."""
    from repro_torch.kernels import lstm_scan as K
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    rows, graphs_ok = {}, True
    for name, S, B, H in SCAN_SHAPES:
        tag = f"{name} S={S} B={B} H={H}"
        xg, w = rnd(S, B, 4 * H, scale=0.5).bfloat16(), rnd(H, 4 * H, scale=H ** -0.5)
        h0, c0 = rnd(B, H, scale=0.1), rnd(B, H, scale=0.1)
        ys, cs = K.lstm_scan_fwd(xg, w, h0, c0)
        torch.cuda.synchronize()
        want = ref.lstm_scan_ref(xg, w, h0, c0)
        err_ys = float((ys.float() - want[0].float()).abs().max())
        err_cs = float((cs - want[1]).abs().max())
        ulps = int(((ys.float() - want[0].float()).abs() > 0).sum())
        if err_ys > SCAN_YS_ATOL or err_cs > SCAN_CS_ATOL or ys.dtype != torch.bfloat16:
            raise AssertionError(f"lstm_scan_fwd {tag}: max|err| ys {err_ys:.2e} (tol "
                                 f"{SCAN_YS_ATOL:.2e}), cs {err_cs:.2e} (tol {SCAN_CS_ATOL})")
        msg = (f"[kernels] lstm_scan_fwd {tag}: max|err| ys {err_ys:.2e} ({ulps} of "
               f"{ys.numel()} bf16 values differ, tol one ulp), cs {err_cs:.2e} "
               f"(tol {SCAN_CS_ATOL})")
        errs = {"lstm_scan_fwd": max(err_ys, err_cs)}
        if name != "decode":
            args = (xg, w, h0, c0, ys, cs, rnd(S, B, H).bfloat16(), rnd(B, H).bfloat16(),
                    rnd(B, H))
            got, rel_b, errs["lstm_scan_bwd"] = _check_scan_bwd(torch, K, ref, args, tag)
            dw, dw_again = K.lstm_scan_dw(h0, ys, got[0]), K.lstm_scan_dw(h0, ys, got[0])
            torch.cuda.synchronize()
            if not torch.equal(dw, dw_again):
                raise AssertionError(f"lstm_scan_dw {tag}: two runs on the same inputs differ")
            want_dw = ref.lstm_scan_dw_ref(h0, ys, got[0])
            rel_dw = _rel_err((dw,), (want_dw,))
            if rel_dw > SCAN_BWD_REL_TOL:
                raise AssertionError(f"lstm_scan_dw {tag}: error relative to max {rel_dw:.2e} > "
                                     f"{SCAN_BWD_REL_TOL}")
            errs["lstm_scan_dw"] = _max_err(torch, (dw,), (want_dw,))
            # the gate recompute alone, twice, against its plain version
            acts, acts_again = (K.lstm_scan_bwd_gates(xg, w, h0, ys) for _ in range(2))
            torch.cuda.synchronize()
            if not torch.equal(acts, acts_again):
                raise AssertionError(f"lstm_scan_bwd_gates {tag}: two runs on the same inputs "
                                     "differ")
            want_acts = ref.lstm_scan_bwd_gates_ref(xg, w, h0, ys)
            rel_g = _rel_err((acts,), (want_acts,))
            if rel_g > SCAN_BWD_REL_TOL:
                raise AssertionError(f"lstm_scan_bwd_gates {tag}: error relative to max "
                                     f"{rel_g:.2e} > {SCAN_BWD_REL_TOL}")
            errs["lstm_scan_bwd_gates"] = _max_err(torch, (acts,), (want_acts,))
            msg += (f"; bwd |err|/max {rel_b:.2e}, its gate recompute {rel_g:.2e}, dw "
                    f"{rel_dw:.2e} (tol {SCAN_BWD_REL_TOL}); backward (two launches, two graph "
                    "replays), gate recompute and dw bitwise repeatable")
            if name == "encoder":
                _log_scan_bwd_phases(torch, K, args, got, tag)
                _log_scan_fwd_phases(torch, K, (xg, w, h0, c0), (ys, cs), tag)
        log(msg)
        if not timing or name == "ragged":
            continue

        # the yardstick: cuDNN's LSTM (torch.nn.LSTM, fp32, TF32 off), which
        # also runs the input product x @ w_ih (B·S·H·4H more) and takes
        # its own layout; the forward without autograd, the backward as
        # forward plus backward
        lib = torch.nn.LSTM(H, H, device="cuda")
        x_lib = rnd(S, B, H, scale=0.5)
        lib_fwd = torch.no_grad()(lambda: lib(x_lib))

        def lib_fwd_bwd():
            x = x_lib.detach().requires_grad_()
            lib(x)[0].sum().backward()

        es, gs = xg.element_size(), 4
        seqs, units = S * B * H, S * B * H
        prod = 2 * S * B * H * 4 * H
        cases = [("lstm_scan_fwd", lambda: K.lstm_scan_fwd(xg, w, h0, c0),
                  lambda: ref.lstm_scan_ref(xg, w, h0, c0), lib_fwd,
                  seqs * 4 * es + 16 * H * H + 2 * B * H * gs + seqs * (es + gs),
                  prod + FWD_OPS_PER_UNIT * units)]
        if name != "decode":
            hp = torch.cat([h0[None], ys[:-1].float()]).reshape(-1, H)
            dg = got[0].reshape(-1, 4 * H)
            cases += [
                # the gate recompute alone; its yardstick the product
                # h_prev @ w_hh, one fp32 matmul
                ("lstm_scan_bwd_gates", lambda: K.lstm_scan_bwd_gates(xg, w, h0, ys),
                 lambda: ref.lstm_scan_bwd_gates_ref(xg, w, h0, ys), lambda: hp @ w,
                 seqs * 4 * es + B * H * gs + seqs * es + 16 * H * H + seqs * 4 * gs, prod),
                ("lstm_scan_bwd", lambda: K.lstm_scan_bwd_rec(*args),
                 lambda: ref.lstm_scan_bwd_rec_ref(*args), lib_fwd_bwd,
                 seqs * 4 * es + 16 * H * H + 2 * B * H * gs + seqs * (2 * es + gs)
                 + B * H * (es + gs) + seqs * 4 * gs + 2 * B * H * gs,
                 2 * prod + (FWD_OPS_PER_UNIT + BWD_OPS_PER_UNIT) * units),
                ("lstm_scan_dw", lambda: K.lstm_scan_dw(h0, ys, got[0]),
                 lambda: ref.lstm_scan_dw_ref(h0, ys, got[0]), lambda: hp.T @ dg,
                 B * H * gs + seqs * es + seqs * 4 * gs + 16 * H * H, prod),
            ]
        if name == "encoder":
            per_sm, sms = K.dw_blocks_per_sm(ys.dtype), torch.cuda.get_device_properties(
                0).multi_processor_count
            log(f"[kernels] lstm_scan_dw {tag}: {K.dw_grid(H)} blocks of {K.DW_TILE[0]} x "
                f"{K.DW_TILE[1]}, {per_sm} resident an SM: {K.dw_grid(H) / (per_sm * sms):.3f} "
                f"waves of {per_sm * sms} on {sms} SMs")
        for kname, kernel, plain, library, nbytes, ops in cases:
            t_k = cuda_ms(torch, kernel, 20)
            g_k = None
            if graphs_ok:
                try:
                    g_k = graph_ms(torch, kernel, 10)
                except RuntimeError as e:  # a measurement, not the port's path
                    graphs_ok = False
                    torch.cuda.synchronize()
                    log(f"[kernels] {kname}: the cooperative launch does not capture in a "
                        f"CUDA graph ({e}); graph times of K2 not measured")
            t_p, g_p = cuda_ms(torch, plain, 3), graph_ms(torch, plain, 3)
            t_l = cuda_ms(torch, library, 10)
            # the products' yardsticks are one matmul each: they capture
            g_l = graph_ms(torch, library, 10) if kname in ("lstm_scan_dw", "lstm_scan_bwd_gates") \
                else None
            bound_ms, bound_by = _bound(nbytes, ops)
            log(f"[kernels] {kname} {tag}: us per call eager/graph: kernel {_us(t_k)}/{_us(g_k)}, "
                f"plain {_us(t_p)}/{_us(g_p)}, library {_us(t_l)}/{_us(g_l)}; bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by}, {ops} flop, {nbytes} B); "
                f"eager time / bound {t_k / bound_ms:.2f}, / library {t_k / t_l:.2f}")
            if name == "encoder":
                rows[kname] = {"max_abs_err": errs[kname], "ms": t_k, "plain_ms": t_p,
                               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t_l}
    for name, S, B, H in SCAN_BWD_SHAPES:
        tag = f"{name} S={S} B={B} H={H}"
        xg, w = rnd(S, B, 4 * H, scale=0.5).bfloat16(), rnd(H, 4 * H, scale=H ** -0.5)
        h0, c0 = rnd(B, H, scale=0.1), rnd(B, H, scale=0.1)
        ys, cs = K.lstm_scan_fwd(xg, w, h0, c0)
        args = (xg, w, h0, c0, ys, cs, rnd(S, B, H).bfloat16(), rnd(B, H).bfloat16(), rnd(B, H))
        _, rel, _ = _check_scan_bwd(torch, K, ref, args, tag)
        log(f"[kernels] lstm_scan_bwd {tag}: |err|/max {rel:.2e} (tol {SCAN_BWD_REL_TOL}); "
            "bitwise repeatable over two launches and two graph replays")
    phase_dw_ragged(torch, gen)
    return rows


# the dw product's ragged shapes: S·B = 37 rows of n (slabs of 16), H = 100
# (tiles of 64 x 128 of dw) with fp32 and bf16 ys, and H = 99, whose rows
# are not 16-byte aligned (the kernel's element-wise route)
DW_RAGGED = ((37, 1, 100, "float32"), (37, 1, 100, "bfloat16"), (37, 1, 99, "bfloat16"))


def phase_dw_ragged(torch, gen) -> None:
    """K2's dw product at DW_RAGGED against its plain version, twice for
    the same bits."""
    from repro_torch.kernels import lstm_scan as K
    from repro_torch.kernels import ref

    for S, B, H, dtype in DW_RAGGED:
        tag = f"ragged S={S} B={B} H={H} {dtype} ys"
        h0 = torch.randn((B, H), generator=gen, device="cuda") * 0.1
        ys = (torch.randn((S, B, H), generator=gen, device="cuda") * 0.5).to(getattr(torch, dtype))
        dg = torch.randn((S, B, 4 * H), generator=gen, device="cuda")
        dw, again = K.lstm_scan_dw(h0, ys, dg), K.lstm_scan_dw(h0, ys, dg)
        torch.cuda.synchronize()
        if not torch.equal(dw, again):
            raise AssertionError(f"lstm_scan_dw {tag}: two runs on the same inputs differ")
        rel = _rel_err((dw,), (ref.lstm_scan_dw_ref(h0, ys, dg),))
        if rel > SCAN_BWD_REL_TOL:
            raise AssertionError(f"lstm_scan_dw {tag}: error relative to max {rel:.2e} > "
                                 f"{SCAN_BWD_REL_TOL}")
        log(f"[kernels] lstm_scan_dw {tag}: |err|/max {rel:.2e} (tol {SCAN_BWD_REL_TOL}); "
            "bitwise repeatable")


# the compression kernels' sizes: the paper's largest leaf (joint and
# encoder w_hh, 1152 x 4608), a 4,096-element leaf, and ragged sizes
WIRE_SIZES = (5_308_416, 4096, 1, 65, 4097)
# K7 at n = 10**8, even (the flat runs) and odd (a row at a time)
K7_LARGE = (100_000_000, 100_000_001)
WIRE_CLIENTS = 4
WIRE_TOPK_FRAC = 0.05


def _bitwise(torch, got, want, what: str) -> None:
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: kernel and plain version differ ({bad} elements; "
                             f"{tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
                             f"{want.dtype})")


def _maybe_graph_ms(torch, fn, n: int, what: str):
    try:
        return graph_ms(torch, fn, n)
    except RuntimeError as e:  # a measurement, not the port's path
        torch.cuda.synchronize()
        log(f"[kernels] {what}: not captured in a CUDA graph ({e}); graph time not measured")
        return None


def _unpack_edge_payload(torch, gen, K: int, k: int, n: int, seg: int, group: int = 0):
    """(K, 2k + 1) int32 indices for K9: drawn with repeats, the first and
    last entries of a row equal, and where a row has 12 or more entries,
    repeats at both sides of the first window edge (``seg``; the middle
    for n <= seg), at both sides of the first window group's edge
    (``group`` elements, where n is past it) and at n - 1, and indices out
    of range (-1, n, 2**31 - 1)."""
    dup = torch.randint(0, n, (K, 2 * k + 1), generator=gen, device="cuda", dtype=torch.int32)
    dup[:, -1] = dup[:, 0]
    w = dup.shape[1]
    if w >= 12:
        edge = seg if n > seg else max(1, n // 2)
        dup[:, 1:w // 2:7] = edge - 1
        dup[:, 2:w // 2:7] = min(edge, n - 1)
        dup[:, 3::11] = n - 1
        dup[:, 4::13] = -1
        dup[:, 5::17] = n
        dup[:, 6::19] = 2**31 - 1
        if 0 < group < n:
            dup[:, w // 2::23] = group - 1
            dup[:, w // 2 + 1::29] = group
    return dup


# K9's routes the path's shapes do not take: int64 indices (clamped to
# [-1, n] before the kernel, some past int32's range), the largest n of one
# histogram (36 Ki windows: the sort's shared histogram at its limit),
# k >= 2**21 (the window place in an array of its own), and the rows the
# sort takes by window groups: one element past the histogram's limit,
# about 2·10⁸, and a group edge with k >= 2**21.
# (K, k, n, index dtype)
UNPACK_ROUTES = ((1, 1000, 30_000_000, "int64"), (1, 4096, 75_497_472, "int32"),
                 (1, 2**21 + 5, 4_194_304, "int32"), (1, 4096, 75_497_473, "int32"),
                 (2, 2**21 + 5, 70_000_000, "int32"))
# the grouped route on the duplicate / out-of-range / window-edge payload,
# K=1: (k, n); the payload has 2k + 1 entries a row
UNPACK_GROUPED = ((755_000, 75_497_473), (2_000_000, 200_000_000))


def _check_unpack_routes(torch, W, ref, gen) -> None:
    for k, n in UNPACK_GROUPED:
        tag = f"K=1 k={2 * k + 1} n={n} duplicate, out-of-range and window-edge indices"
        dup = _unpack_edge_payload(torch, gen, 1, k, n, W.SEGMENT,
                                   W.UNPACK_GROUP_WINDOWS * W.SEGMENT)
        vals = torch.randn(dup.shape, generator=gen, device="cuda")
        got, scratch = W._topk_unpack_kernels(vals, dup, n)
        _bitwise(torch, got, ref.topk_unpack_ref(vals, dup, n), f"topk_unpack {tag}")
        _check_unpack_layout(torch, W, W.kernel_layout(scratch, 1, dup.shape[1], n), dup, n, tag)
        log(f"[kernels] topk_unpack {tag} ({-(-n // W.SEGMENT)} windows a row, sorted by "
            f"window groups of {W.UNPACK_GROUP_WINDOWS}): bitwise equal to the plain version, "
            "its layout the plain one's")
        del got, scratch, dup, vals
    for K, k, n, dtype in UNPACK_ROUTES:
        tag = f"K={K} k={k} n={n} {dtype} indices"
        idx = torch.randint(-3, n + 3, (K, k), generator=gen, device="cuda",
                            dtype=getattr(torch, dtype))
        if dtype == "int64":
            idx[:, :3] = torch.tensor([2**32 + 5, -(2**40), 2**31], device="cuda")
        vals = torch.randn((K, k), generator=gen, device="cuda")
        got, scratch = W._topk_unpack_kernels(vals, idx, n)
        _bitwise(torch, got, ref.topk_unpack_ref(vals, idx, n), f"topk_unpack {tag}")
        _check_unpack_layout(torch, W, W.kernel_layout(scratch, K, k, n), idx, n, tag)
        log(f"[kernels] topk_unpack {tag} ({-(-n // W.SEGMENT)} windows a row, "
            f"{-(-k // W.UNPACK_CHUNK)} chunks): bitwise equal to the plain version, its layout "
            "the plain one's")
        del got, scratch


def _check_scatter_add_large(torch, W, ref, gen) -> None:
    """K8 at SCATTER_ADD_LARGE against its plain version bitwise, twice and
    from one CUDA graph."""
    K, n = SCATTER_ADD_LARGE
    k = n // 100
    pool = torch.randperm(n, generator=gen, device="cuda")[:2 * k]
    idx = torch.stack([pool[torch.randperm(2 * k, generator=gen, device="cuda")[:k]]
                       for _ in range(K)]).to(torch.int32)
    vals = torch.randn((K, k), generator=gen, device="cuda")
    weights = torch.tensor([4.0, 2.0, 3.0, 1.0], device="cuda")
    tag = f"K={K} k={k} n={n}"
    _check_scatter_add(torch, W, ref, vals, idx, weights, n, tag, graph=True)
    shared = K * k - int(torch.unique(idx).numel())
    log(f"[kernels] topk_scatter_add {tag} ({-(-n // W.SEGMENT)} windows, sorted by window "
        f"groups of {W.UNPACK_GROUP_WINDOWS}; {shared} indices picked by more than one "
        "client): bitwise equal to the plain version, twice and from one CUDA graph")
    _log_launch_times(torch, "topk_scatter_add", lambda: W.topk_scatter_add(vals, idx, weights, n),
                      ("topk_unpack", "topk_scatter_add"), tag, calls=5)


def _check_unpack_layout(torch, W, layout, idx, n: int, tag: str) -> None:
    """K9's starts bitwise the plain layout's; its slots the same after
    each chunk's runs are put in payload order."""
    starts, slots = layout
    want_starts, want_slots = W.unpack_layout(idx, n)
    _bitwise(torch, starts, want_starts, f"topk_unpack starts {tag}")
    K, k = idx.shape
    nseg = starts.shape[2] - 1
    pos = torch.arange(k, device=idx.device)
    chunk = pos // W.UNPACK_CHUNK
    valid = (pos - chunk * W.UNPACK_CHUNK)[None] < starts[:, chunk, nseg]
    j = torch.where(valid, slots, 0).long()
    window = torch.gather(idx.long(), 1, j).div(W.SEGMENT, rounding_mode="floor")
    span = (nseg + 1) * k  # a chunk's keys, below the next chunk's
    key = torch.where(valid, chunk * span + window * k + j, chunk * span + nseg * k + pos)
    ordered = torch.sort(key, dim=1).values % k
    _bitwise(torch, torch.where(valid, ordered, -1).int(), want_slots, f"topk_unpack slots {tag}")


def _check_unpack_graph(torch, W, values, idx, n: int, want, tag: str) -> None:
    """K9 captured in one CUDA graph, replayed twice into a zeroed output:
    the plain version's bits each time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        W.topk_unpack(values, idx, n)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = W.topk_unpack(values, idx, n)
    for r in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        _bitwise(torch, out, want, f"topk_unpack from a CUDA graph, replay {r + 1} {tag}")
    del graph


def _log_launch_times(torch, what: str, fn, names, tag: str, calls: int = 20) -> None:
    """Each launch of a wrapper's call alone: device time by kernel (names
    holding one of ``names``, and any memset) under the profiler over
    ``calls`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {name.replace("(anonymous namespace)::", "").split("(")[0]: t / calls
               for name, (t, c) in _device_times(torch, prof).items()
               if any(k in name for k in names) or "emset" in name}
    if not by_name:
        log(f"[kernels] {what} {tag}: the profiler recorded no device events: "
            "per-kernel times not measured")
        return
    parts = ", ".join(f"{name} {t:.2f}" for name, t in sorted(by_name.items(),
                                                               key=lambda kv: -kv[1]))
    log(f"[kernels] {what} {tag}: device us a call by launch: {parts}; sum "
        f"{sum(by_name.values()):.2f}")


def _check_scatter_add(torch, W, ref, values, idx, weights, n: int, tag: str,
                       graph: bool = False):
    """K8 against its plain version bitwise, twice for the same bits and,
    with ``graph``, replayed twice from one CUDA graph into a zeroed
    output. Returns the kernel's output."""
    dense = W.topk_scatter_add(values, idx, weights, n)
    again = W.topk_scatter_add(values, idx, weights, n)
    want = ref.topk_scatter_add_ref(values, idx, weights, n)
    _bitwise(torch, dense, want, f"topk_scatter_add {tag}")
    _bitwise(torch, again, dense, f"topk_scatter_add twice {tag}")
    if graph:
        replays = _graph_outputs(torch, lambda: W.topk_scatter_add(values, idx, weights, n))
        for r, (out,) in enumerate(replays):
            _bitwise(torch, out, want, f"topk_scatter_add from a CUDA graph, replay {r + 1} {tag}")
    return dense


# K8 past the histogram's windows: K=4 clients, k = 1 % of n a row, the
# rows drawn from one pool of 2k indices (distinct within a row, shared
# across rows), the sort by window groups
SCATTER_ADD_LARGE = (4, 100_000_000)


# the normal kernel's ragged table: (numel, dtype name, scale kind), with
# scale kinds "value" (a float), "device" (a 0-dim tensor) and "slices" (a
# (4,) tensor over 4 equal slices, as the gaussian adversary's), and 70
# leaves of 3 to 72 elements (two launches of 64 and 6)
NORMAL_RAGGED = ((1, "float32", "value"), (2, "bfloat16", "device"), (3, "float32", "value"),
                 (5, "bfloat16", "value"), (513, "float32", "device"),
                 (4_096, "bfloat16", "slices"), (4_097, "float32", "value"),
                 (1_000_001, "bfloat16", "value"), (5_308_416, "float32", "slices"))
NORMAL_SMALL_LEAVES = 70


def normal_edges(KN):
    """The normal kernel's run edges (``KN.RUN_EDGES``) as leaf specs:
    fp32 and bf16 in turn, and in turn the kinds of scale that fit n (four
    equal slices only where 4 divides n)."""
    specs = []
    for i, n in enumerate(KN.RUN_EDGES):
        kinds = ("value", "device", "slices") if n % 4 == 0 else ("value", "device")
        specs.append((n, ("float32", "bfloat16")[i % 2], kinds[i % len(kinds)]))
    return tuple(specs)


# XLA's log1p takes Cephes's branch where |y| < this (y = -u·u)
NORMAL_CEPHES_BELOW = 0.41421357


def _cephes_draws(torch, ref, f) -> int:
    """The draws among the [0, 1) fills ``f`` whose log1p takes Cephes's
    branch: |u·u| < sqrt(2) - 1 for u = max(lo, f · 2 + lo), the sum in
    fp64 and rounded once (exact, as the fmaf)."""
    lo = torch.tensor(ref.NORMAL_LO, dtype=torch.float32, device=f.device)
    u = torch.maximum(lo, (f.double() * 2.0 + lo.double()).float())
    below = torch.tensor(NORMAL_CEPHES_BELOW, dtype=torch.float32, device=f.device)
    return int(((u * -u).abs() < below).sum())


def _normal_case(torch, gen, spec):
    """(tensors, scales) of a table: values N(0, 1) from ``gen``."""
    xs, scales = [], []
    for numel, dname, kind in spec:
        xs.append(torch.randn(numel, generator=gen, device="cuda").to(getattr(torch, dname)))
        if kind == "value":
            scales.append(0.01)
        elif kind == "device":
            scales.append(torch.tensor(0.02, device="cuda"))
        else:
            scales.append(torch.tensor([0.5, 0.0, -1.5, 0.01], device="cuda"))
    return xs, scales


def phase_normal_kernel(torch):
    """The normal kernel (FVN's noise, the gaussian adversary's, the DP
    noise) against its plain version on the card, bit for bit: at
    rnnt-librispeech's 35 leaves (fp32, the parameters a client step
    perturbs, through fvn.perturb as the step calls it and through the
    wrapper), at ragged sizes with bf16 leaves and every kind of scale,
    over 70 small leaves (two launches), at its run edges (normal_edges)
    and on leaves off the 16-byte grid; its device normal on all 2**23
    fills (threefry_normal_words). At the paper's table its time
    (eager and from a CUDA graph) beside its bound, its plain version, the
    per-leaf path before it (``torch.randn``, ``sigma *``, ``+`` a leaf)
    and one ``torch.randn`` of as many values, a reference point (no
    PyTorch call computes the same function). Returns its row."""
    from repro_torch.core import fvn, keys
    from repro_torch.core.compression import jax_leaf_order
    from repro_torch.kernels import ref
    from repro_torch.kernels import threefry_normal as KN

    gen = torch.Generator(device="cuda").manual_seed(11)
    params = _paper_task(True).init_params(gen)
    names = list(params)
    key = fvn.fvn_key(keys.PRNGKey(0), 1, 2, 1)
    sigma = 0.01
    xs = [params[n] for n in jax_leaf_order(names)]
    lkeys = keys.split(key, len(xs))
    n_elems = sum(x.numel() for x in xs)
    got = KN.normal_axpy(xs, lkeys, [sigma] * len(xs))
    want = ref.normal_axpy_ref(xs, lkeys, [sigma] * len(xs))
    for x, g, w in zip(xs, got, want):
        _bitwise(torch, g, w, f"threefry_normal paper leaf {tuple(x.shape)}")
    perturbed = fvn.perturb(params, key, sigma)
    for n, g in zip(jax_leaf_order(names), got):
        _bitwise(torch, perturbed[n], g, f"fvn.perturb {n}")
    _bitwise(torch, KN.normal_axpy(xs, lkeys, [sigma] * len(xs))[0], got[0],
             "threefry_normal twice")
    log(f"[kernels] threefry_normal paper table ({len(xs)} leaves, {n_elems} fp32 elements, "
        f"sigma {sigma}): bitwise equal to its plain version, through the wrapper and through "
        f"fvn.perturb, and on a second call; the leaves whose half (n + 1) // 2 is a multiple "
        f"of 4 (every run of the normal kernel whole and aligned) "
        f"{sum((x.numel() + 1) // 2 % 4 == 0 for x in xs)} of {len(xs)}; K7 on these leaves: "
        f"n even (the nibble kernels' flat runs) {sum(x.numel() % 2 == 0 for x in xs)}, n a "
        f"multiple of 16 (no dequantize run across a row's end) "
        f"{sum(x.numel() % 16 == 0 for x in xs)}")
    del got, want, perturbed
    for spec, tag in ((NORMAL_RAGGED, "ragged"),
                      (tuple((3 + i, "bfloat16" if i % 3 else "float32",
                              ("value", "device")[i % 2]) for i in range(NORMAL_SMALL_LEAVES)),
                       f"{NORMAL_SMALL_LEAVES} small leaves"),
                      (normal_edges(KN), "run edges")):
        rx, rs = _normal_case(torch, gen, spec)
        rk = keys.split(keys.fold_in(key, len(spec)), len(spec))
        before = KN.NORMAL_LAUNCHES
        got = KN.normal_axpy(rx, rk, rs)
        launches = KN.NORMAL_LAUNCHES - before
        if launches != -(-len(spec) // KN.max_leaves()):
            raise AssertionError(f"threefry_normal {tag}: {launches} launches for "
                                 f"{len(spec)} leaves")
        for x, g, w in zip(rx, got, ref.normal_axpy_ref(rx, rk, rs)):
            _bitwise(torch, g, w, f"threefry_normal {tag} {x.numel()} {x.dtype}")
        log(f"[kernels] threefry_normal {tag} ({len(spec)} leaves, fp32 and bf16, scales by "
            f"value, from the device and over equal slices; {launches} launch(es)): bitwise "
            f"equal to its plain version")
        del rx, got
    _check_normal_offsets(torch, gen, KN, ref, keys, key)
    _check_normal_words(torch, KN, ref)
    n_cephes = sum(_cephes_draws(torch, ref, ref.threefry_uniform_ref(k.to("cuda"), x.numel()))
                   for x, k in zip(xs, lkeys))

    def kernel():
        return KN.normal_axpy(xs, lkeys, [sigma] * len(xs))

    def as_the_step_calls_it():
        return fvn.perturb(params, key, sigma)

    def plain():
        return ref.normal_axpy_ref(xs, lkeys, [sigma] * len(xs))

    def per_leaf_randn():  # the per-leaf path before the kernel (the default generator)
        return {n: (p.float() + sigma * torch.randn(p.shape, device=p.device)).to(p.dtype)
                for n, p in params.items()}

    def randn_alone():
        return torch.randn(n_elems, device="cuda")

    t_k, g_k = cuda_ms(torch, kernel, 20), graph_ms(torch, kernel, 10)
    t_step = cuda_ms(torch, as_the_step_calls_it, 20)
    t_p = cuda_ms(torch, plain, 2)
    t_old = cuda_ms(torch, per_leaf_randn, 20)
    g_old = _maybe_graph_ms(torch, per_leaf_randn, 10, "the per-leaf randn path")
    t_r = cuda_ms(torch, randn_alone, 20)
    g_r = _maybe_graph_ms(torch, randn_alone, 10, "torch.randn")
    nbytes = sum(2 * x.numel() * x.element_size() for x in xs) + 8 * len(xs)
    blocks = sum((x.numel() + 1) // 2 for x in xs)
    n_eigen = n_elems - n_cephes
    int_ops = blocks * WIRE_BLOCK_INT_OPS + n_elems * WIRE_ELEM_INT_OPS
    fp_ops = (n_cephes * NORMAL_CEPHES_FP_OPS + n_eigen * NORMAL_EIGEN_FP_OPS
              + n_elems * NORMAL_ELEM_FP_OPS)
    t_b, t_i, t_f = nbytes / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S, fp_ops / FP32_OPS_PER_S
    bound_ms = max(t_b, t_i, t_f) * 1e3
    bound_by = "bytes" if t_b >= max(t_i, t_f) else "operations"
    log(f"[kernels] threefry_normal paper table: ms per call eager/graph: kernel "
        f"{t_k:.4f}/{g_k:.4f}; as fvn.perturb calls it (the leaf keys split on the host) "
        f"{t_step:.4f} eager; plain {t_p:.3f}; the per-leaf path before it (randn, sigma *, + "
        f"for {len(xs)} leaves, {3 * len(xs)} launches) {t_old:.4f}/{_ms(g_old)}; torch.randn "
        f"of {n_elems} values (a reference point) {t_r:.4f}/{_ms(g_r)}; bound {bound_ms:.4f} "
        f"({bound_by}: {nbytes} B {t_b * 1e3:.4f} ms, {int_ops} int32 ops {t_i * 1e3:.4f} ms, "
        f"{fp_ops} fp32 ops {t_f * 1e3:.4f} ms with one log1p branch a draw, Cephes's for "
        f"{n_cephes} of {n_elems} draws ({n_cephes / n_elems:.4f})); eager time / bound "
        f"{t_k / bound_ms:.2f}")
    return {"threefry_normal": {"max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "library_ms": None}}


def _check_normal_offsets(torch, gen, KN, ref, keys, key) -> None:
    """Leaves whose data starts off the 16-byte grid (views 1 and 4,097
    elements into a tensor, fp32 and bf16) against the plain version, bit
    for bit: every run takes the kernel's element-by-element path."""
    for dname in ("float32", "bfloat16"):
        base = torch.randn(2 * 4_096 + 1, generator=gen, device="cuda").to(getattr(torch, dname))
        views = [base[1:4_097], base[4_097:]]
        vk = keys.split(keys.fold_in(key, 7), len(views))
        for x, g, w in zip(views, KN.normal_axpy(views, vk, [0.01, 0.01]),
                           ref.normal_axpy_ref(views, vk, [0.01, 0.01])):
            _bitwise(torch, g, w, f"threefry_normal {dname} view at offset "
                     f"{x.storage_offset()}")
    log("[kernels] threefry_normal leaves off the 16-byte grid (fp32 and bf16 views 1 and "
        "4,097 elements in): bitwise equal to its plain version")


def _check_normal_words(torch, KN, ref) -> None:
    """The kernel's normal (threefry_normal_words, its device code over
    given words) on all 2**23 fills, words f << 9, against the plain
    version's ref.uniform_to_normal, bit for bit; and the share of the
    fills whose log1p takes Cephes's branch."""
    words = torch.arange(2**23, device="cuda", dtype=torch.int64) << 9
    signed = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    f = ref.bits_to_uniform(words)
    _bitwise(torch, KN.word_normals(signed), ref.uniform_to_normal(f),
             "threefry_normal_words on all 2**23 fills")
    log(f"[kernels] threefry_normal's device normal on all 2**23 fills (words f << 9, "
        f"threefry_normal_words): bitwise equal to ref.uniform_to_normal; Cephes's log1p "
        f"branch for {_cephes_draws(torch, ref, f)} of {2**23} fills")


# K5's and K6's edges beyond WIRE_SIZES: n of 2 and 3, one n of each
# residue mod 4 (a high-half byte of K5 spans two threefry blocks when
# (n + 1) // 2 is odd), a few blocks of threads, and n = 10**8 at K = 2
QUANT_EDGE_SIZES = (2, 3, 5, 6, 7, 8, 513, 100_000_000)


def _check_quantizer_edges(torch, W, ref, gen) -> None:
    """The quantizer in every rounding, int8 codes and int4 codes and
    bytes, with a shared scale and one a client, against its plain
    version at QUANT_EDGE_SIZES, bit for bit."""
    for n in QUANT_EDGE_SIZES:
        K = 2 if n > 10**7 else WIRE_CLIENTS
        x = torch.randn((K, n), generator=gen, device="cuda") * 1e-3
        x[:, ::97] = 0.0
        keys = torch.randint(0, 2**32, (K, 2), generator=gen, device="cuda", dtype=torch.int64)
        u = torch.rand((K, n), generator=gen, device="cuda")
        checked = 0
        for bits in (8, 4):
            lv = 2.0 ** (bits - 1) - 1.0
            per_client = x.abs().amax(dim=1) / lv * 0.9
            per_client[0] = 1.0  # a row at the all-zero tensor's scale
            for scale in (x.abs().max() / lv * 0.9, per_client):
                draws = ref.threefry_uniform_ref(keys, n)
                for what, uu, kernel_codes, kernel_pack in (
                        ("keyed", draws, lambda: W.quantize_with_scale_keyed(x, scale, keys, bits),
                         lambda: W.quantize_pack_keyed(x, scale, keys, bits)),
                        ("streamed", u, lambda: W.quantize_with_scale(x, scale, u, bits),
                         lambda: W.quantize_pack(x, scale, u, bits)),
                        ("nearest", None, lambda: W.quantize_with_scale(x, scale, None, bits),
                         lambda: W.quantize_pack(x, scale, None, bits))):
                    tag = f"wire_quantize {what} int{bits} K={K} n={n} scale {tuple(scale.shape)}"
                    _bitwise(torch, kernel_codes(),
                             ref.quantize_codes_with_scale_ref(x, scale, uu, lv), f"{tag} codes")
                    _bitwise(torch, kernel_pack(), ref.quantize_pack_ref(x, scale, uu, bits),
                             f"{tag} wire buffer")
                    checked += 2
                del draws
        log(f"[kernels] wire_quantize K={K} n={n}: {checked} variants (keyed, streamed, nearest; "
            f"int8 and int4 codes and wire buffers; a shared scale and one a client) bitwise "
            f"equal to the plain versions")
        del x, u


def _check_k7(torch, W, ref, gen, K: int, n: int) -> None:
    """K7's three kernels against their plain versions at (K, n), bit for
    bit: int4 codes packed and unpacked, int8 codes dequantized with a
    shared scale and with one a client."""
    codes = torch.randint(-8, 8, (K, n), generator=gen, device="cuda", dtype=torch.int8)
    packed = W.nibble_pack(codes)
    _bitwise(torch, packed, ref.nibble_pack_ref(codes), f"nibble_pack K={K} n={n}")
    _bitwise(torch, W.nibble_unpack(packed, n), ref.nibble_unpack_ref(packed, n),
             f"nibble_unpack K={K} n={n}")
    _bitwise(torch, W.nibble_unpack(packed, n), codes, f"nibble pack then unpack K={K} n={n}")
    del packed
    codes = torch.randint(-127, 128, (K, n), generator=gen, device="cuda", dtype=torch.int8)
    scales = torch.rand(K, generator=gen, device="cuda") * 1e-3 + 1e-5
    for what, scale in (("per-client", scales), ("shared", scales[min(1, K - 1)])):
        _bitwise(torch, W.dequantize(codes, scale), ref.dequantize_ref(codes, scale),
                 f"dequantize {what} scale K={K} n={n}")


def _check_k7_edges(torch, W, ref, gen) -> None:
    """K7 at n = 10**8 (K7_LARGE: the flat runs of an even n, the rows of
    an odd one) at K = 4, and at its run edges (``W.K7_RUN_EDGES``) at
    K = 3 (odd n: every row but the first off the 16-byte grid)."""
    for K, sizes in ((WIRE_CLIENTS, K7_LARGE), (3, W.K7_RUN_EDGES)):
        for n in sizes:
            _check_k7(torch, W, ref, gen, K, n)
        log(f"[kernels] K7 (nibble pack, unpack, dequantize with a shared and a per-client "
            f"scale) K={K} n={', '.join(map(str, sizes))}: bitwise equal to the plain versions")


def _check_k1(torch, W, ref, gen) -> None:
    """The fedsgd round's compress at K = 1 (the aggregate as one client's
    delta): the keyed quantizer (int8 and int4 codes, int4 nibble bytes)
    with the row's own scale and with a shared one, K7's pack, unpack and
    dequantize, at WIRE_SIZES and K7's run edges, bit for bit."""
    sizes = WIRE_SIZES + W.K7_RUN_EDGES
    for n in sizes:
        x = torch.randn((1, n), generator=gen, device="cuda") * 1e-3
        x[:, ::97] = 0.0
        keys = torch.randint(0, 2**32, (1, 2), generator=gen, device="cuda", dtype=torch.int64)
        draws = ref.threefry_uniform_ref(keys, n)
        for bits in (8, 4):
            lv = 2.0 ** (bits - 1) - 1.0
            row = x.abs().amax(dim=1) / lv  # pack_leaf's scale: the row's absmax
            for what, scale in (("row", row), ("shared", row[0] * 0.9)):
                tag = f"wire_quantize keyed int{bits} K=1 n={n} {what} scale"
                _bitwise(torch, W.quantize_with_scale_keyed(x, scale, keys, bits),
                         ref.quantize_codes_with_scale_ref(x, scale, draws, lv), f"{tag} codes")
                _bitwise(torch, W.quantize_pack_keyed(x, scale, keys, bits),
                         ref.quantize_pack_ref(x, scale, draws, bits), f"{tag} wire buffer")
        _check_k7(torch, W, ref, gen, 1, n)
        del x, draws
    log(f"[kernels] K=1 (the fedsgd aggregate) n={', '.join(map(str, sizes))}: the keyed "
        f"quantizer (int8 and int4 codes and wire buffers, the row's scale and a shared one), "
        f"nibble pack and unpack, dequantize bitwise equal to the plain versions")


def phase_wire_kernels(torch):
    """The compression kernels against their plain versions at K=4 clients
    and WIRE_SIZES with K7's run edges: the quantizer in each rounding (keyed, streamed,
    nearest) giving int8 codes and int4 nibble bytes, the nibble pack and
    unpack, and the top-k scatter-add (5% of each row, with indices shared
    across clients), all bitwise; the scatter-add twice for the same bits;
    K7 also at n = 10**8 (K=4, even and odd) and its run edges at K=3.
    At the largest leaf each kernel's time (eager and from a CUDA graph)
    beside its bound, its plain version and, for the scatter-add, a
    library yardstick. Returns {kernel: row at the largest leaf}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import wire_pack as W

    gen = torch.Generator(device="cuda").manual_seed(3)
    K = WIRE_CLIENTS
    rows = {}
    for n in WIRE_SIZES + W.K7_RUN_EDGES:
        tag = f"K={K} n={n}"
        # correlated clients, as a round's deltas are: shared top-k picks
        base = torch.randn(n, generator=gen, device="cuda") * 1e-3
        x = (base + torch.randn((K, n), generator=gen, device="cuda") * 2e-4).contiguous()
        x[:, ::97] = 0.0
        keys = torch.randint(0, 2**32, (K, 2), generator=gen, device="cuda", dtype=torch.int64)
        u = torch.rand((K, n), generator=gen, device="cuda")
        calls = {}
        for bits in (8, 4):
            scale = x.abs().max() / (2 ** (bits - 1) - 1) * 0.9  # the largest values clamp
            calls[f"keyed int{bits} codes"] = (
                lambda s=scale, b=bits: W.quantize_with_scale_keyed(x, s, keys, b),
                lambda s=scale, b=bits: ref.quantize_codes_with_scale_ref(
                    x, s, ref.threefry_uniform_ref(keys, n), 2.0 ** (b - 1) - 1.0))
            calls[f"streamed int{bits} codes"] = (
                lambda s=scale, b=bits: W.quantize_with_scale(x, s, u, b),
                lambda s=scale, b=bits: ref.quantize_codes_with_scale_ref(
                    x, s, u, 2.0 ** (b - 1) - 1.0))
            calls[f"nearest int{bits} codes"] = (
                lambda s=scale, b=bits: W.quantize_with_scale(x, s, None, b),
                lambda s=scale, b=bits: ref.quantize_codes_with_scale_ref(
                    x, s, None, 2.0 ** (b - 1) - 1.0))
        scale4 = x.abs().max() / 7 * 0.9
        calls["keyed int4 packed"] = (
            lambda: W.quantize_pack_keyed(x, scale4, keys, 4),
            lambda: ref.quantize_pack_ref(x, scale4, ref.threefry_uniform_ref(keys, n), 4))
        calls["streamed int4 packed"] = (lambda: W.quantize_pack(x, scale4, u, 4),
                                         lambda: ref.quantize_pack_ref(x, scale4, u, 4))
        calls["nearest int4 packed"] = (lambda: W.quantize_pack(x, scale4, None, 4),
                                        lambda: ref.quantize_pack_ref(x, scale4, None, 4))
        for what, (kernel, plain) in calls.items():
            _bitwise(torch, kernel(), plain(), f"wire_quantize {what} {tag}")
        # the slow path quantizes each client against its own scale
        for bits in (8, 4):
            lv = 2.0 ** (bits - 1) - 1.0
            sk = x.abs().amax(dim=1) / lv * 0.9
            sk[0] = 1.0  # a row at the all-zero tensor's scale
            calls[f"keyed int{bits} packed, per-client scale"] = (
                lambda s=sk, b=bits: W.quantize_pack_keyed(x, s, keys, b),
                lambda s=sk, b=bits: ref.quantize_pack_ref(x, s, ref.threefry_uniform_ref(keys, n),
                                                           b))
            calls[f"streamed int{bits} codes, per-client scale"] = (
                lambda s=sk, b=bits: W.quantize_with_scale(x, s, u, b),
                lambda s=sk, lv=lv: ref.quantize_codes_with_scale_ref(x, s, u, lv))
            calls[f"nearest int{bits} packed, per-client scale"] = (
                lambda s=sk, b=bits: W.quantize_pack(x, s, None, b),
                lambda s=sk, b=bits: ref.quantize_pack_ref(x, s, None, b))
        for what, (kernel, plain) in calls.items():
            if "per-client" in what:
                _bitwise(torch, kernel(), plain(), f"wire_quantize {what} {tag}")
        codes = W.quantize_with_scale_keyed(x, scale4, keys, 4)
        packed = W.nibble_pack(codes)
        _bitwise(torch, packed, ref.nibble_pack_ref(codes), f"nibble_pack {tag}")
        _bitwise(torch, W.nibble_unpack(packed, n), ref.nibble_unpack_ref(packed, n),
                 f"nibble_unpack {tag}")
        _bitwise(torch, W.nibble_unpack(packed, n), codes, f"nibble pack then unpack {tag}")
        # K7 dequantize: int8 codes at a scale a client, and one shared
        codes8 = W.quantize_with_scale_keyed(x, scale4 * 7 / 127, keys, 8)
        scales = x.abs().amax(dim=1) / 127
        _bitwise(torch, W.dequantize(codes8, scales), ref.dequantize_ref(codes8, scales),
                 f"dequantize per-client scale {tag}")
        _bitwise(torch, W.dequantize(codes, scale4), ref.dequantize_ref(codes, scale4),
                 f"dequantize shared scale {tag}")
        k = max(1, min(n, math.ceil(WIRE_TOPK_FRAC * n)))
        idx = torch.topk(x.abs(), k, dim=1).indices.to(torch.int32)
        vals = torch.gather(x, 1, idx.long())
        weights = torch.tensor([4.0, 2.0, 3.0, 1.0], device="cuda")
        # K9 top-k unpack: the path's distinct indices, then duplicates (the
        # last pair in payload order wins)
        _bitwise(torch, W.topk_unpack(vals, idx, n), ref.topk_unpack_ref(vals, idx, n),
                 f"topk_unpack {tag}")
        _bitwise(torch, W.topk_unpack(vals, idx, n),
                 torch.zeros((K, n), device="cuda").scatter_(1, idx.long(), vals),
                 f"topk_unpack against scatter_ {tag}")
        dup = _unpack_edge_payload(torch, gen, K, k, n, W.SEGMENT)
        dvals = torch.randn(dup.shape, generator=gen, device="cuda")
        want_dup = ref.topk_unpack_ref(dvals, dup, n)
        got_dup, scratch = W._topk_unpack_kernels(dvals, dup, n)
        layout = W.kernel_layout(scratch, K, dup.shape[1], n)
        _bitwise(torch, got_dup, want_dup,
                 f"topk_unpack with duplicate, out-of-range and window-edge indices {tag}")
        _check_unpack_layout(torch, W, layout, dup, n, tag)
        _check_unpack_graph(torch, W, dvals, dup, n, want_dup, tag)
        n_dup = K * dup.shape[1] - sum(int(torch.unique(r).numel()) for r in dup)
        n_out = int(((dup < 0) | (dup >= n)).sum())
        dense = _check_scatter_add(torch, W, ref, vals, idx, weights, n, tag,
                                   graph=n == WIRE_SIZES[0])
        # negative and zero weights, -0.0 values, indices out of range
        signed = vals.clone()
        signed[:, ::5] = -0.0
        bad_idx = idx.clone()
        bad_idx[:, 1::9], bad_idx[:, 2::9], bad_idx[:, 3::9] = -1, n, 2**31 - 1
        _check_scatter_add(torch, W, ref, signed, bad_idx,
                           torch.tensor([-1.5, 0.0, 2.0, -0.0], device="cuda"), n,
                           f"{tag} with -0.0 values, weights -1.5, 0, 2, -0 and indices "
                           "out of range")
        shared = K * k - int(torch.unique(idx).numel())
        log(f"[kernels] wire {tag}: quantizer ({len(calls)} variants, per-client scales "
            f"included), nibble pack and unpack, dequantize (shared and per-client scale), "
            f"top-k scatter-add ({k} of each row, {shared} indices picked by more than one "
            f"client; again with -0.0 values, negative and zero weights and indices out of "
            f"range{'; replayed from one CUDA graph' if n == WIRE_SIZES[0] else ''}), top-k unpack ({k} of each row; and {dup.shape[1]} a row with {n_dup} "
            f"repeated indices, {n_out} out of range, runs across window edges: its layout "
            f"the plain one's, bitwise again from one CUDA graph) bitwise equal to the plain "
            f"versions; scatter-add bitwise repeatable")
        if n != WIRE_SIZES[0]:
            continue
        _check_unpack_routes(torch, W, ref, gen)
        _check_scatter_add_large(torch, W, ref, gen)
        _check_quantizer_edges(torch, W, ref, gen)
        _check_k7_edges(torch, W, ref, gen)
        _check_k1(torch, W, ref, gen)

        # times at the largest leaf, as the main path calls each kernel
        flat_idx = idx.reshape(-1).long()

        def library_scatter():  # the same function by index_add_, deterministic
            return torch.zeros(n, device="cuda").index_add_(
                0, flat_idx, (weights[:, None] * vals).reshape(-1))

        lib_ms = None
        was_deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            lib_err = float((library_scatter() - dense).abs().max())
            lib_ms = cuda_ms(torch, library_scatter, 20)
            log(f"[kernels] topk_scatter_add {tag}: deterministic index_add_ agrees to "
                f"{lib_err:.2e}")
        except RuntimeError as e:
            log(f"[kernels] topk_scatter_add {tag}: deterministic index_add_ unavailable: {e}")
        finally:
            torch.use_deterministic_algorithms(was_deterministic)
        idx_long = idx.long()

        def library_unpack():  # the same function for distinct indices
            return torch.zeros((K, n), device="cuda").scatter_(1, idx_long, vals)

        def library_dequantize():  # one PyTorch call: int8 times fp32 promotes
            return codes8 * scales[:, None]

        t_lib_unpack = cuda_ms(torch, library_unpack, 20)

        def zeros():  # the output's write alone: the floor of K9's window pass
            return torch.zeros((K, n), device="cuda")

        log(f"[kernels] topk_unpack {tag}: library (scatter_ into zeros) from a CUDA graph "
            f"{_us(graph_ms(torch, library_unpack, 20))} us; the output's write alone "
            f"(torch.zeros of (K, n)) {_us(cuda_ms(torch, zeros, 20))}/"
            f"{_us(graph_ms(torch, zeros, 20))} us eager/graph")
        _log_launch_times(torch, "topk_unpack", lambda: W.topk_unpack(vals, idx, n),
                          ("topk_unpack",), tag)
        _log_launch_times(torch, "topk_scatter_add",
                          lambda: W.topk_scatter_add(vals, idx, weights, n),
                          ("topk_unpack", "topk_scatter_add"), tag)
        t_lib_deq = cuda_ms(torch, library_dequantize, 50)
        m, nb, kn = K * k, (n + 1) // 2, K * n
        keyed_int_ops = K * (nb * WIRE_BLOCK_INT_OPS + n * WIRE_ELEM_INT_OPS)
        cases = (
            # (name, variant, kernel, plain, library, bytes, int ops, fp ops);
            # a kernel's row in the kernels line is its first case with a
            # plain version, which times the same function as the plain
            # version and the library call
            ("wire_quantize", "keyed int4 packed", calls["keyed int4 packed"][0],
             calls["keyed int4 packed"][1], None, 4 * kn + K * nb + 4 + 8 * K,
             keyed_int_ops, WIRE_QUANT_FP_OPS * kn),
            ("wire_quantize", "keyed int8 codes", calls["keyed int8 codes"][0],
             calls["keyed int8 codes"][1], None, 5 * kn + 4 + 8 * K, keyed_int_ops,
             WIRE_QUANT_FP_OPS * kn),
            ("wire_quantize", "nearest int8 codes", calls["nearest int8 codes"][0],
             calls["nearest int8 codes"][1], None, 5 * kn + 4, 0, WIRE_QUANT_FP_OPS * kn),
            ("wire_quantize", "streamed int4 packed", calls["streamed int4 packed"][0],
             calls["streamed int4 packed"][1], None, 8 * kn + K * nb + 4, 0,
             WIRE_QUANT_FP_OPS * kn),
            ("nibble_pack", "", lambda: W.nibble_pack(codes), lambda: ref.nibble_pack_ref(codes),
             None, kn + K * nb, 3 * K * nb, 0),
            ("nibble_unpack", "", lambda: W.nibble_unpack(packed, n),
             lambda: ref.nibble_unpack_ref(packed, n), None, K * nb + kn, 4 * kn, 0),
            ("dequantize", "int8 codes, per-client scale", lambda: W.dequantize(codes8, scales),
             lambda: ref.dequantize_ref(codes8, scales), t_lib_deq, kn + 4 * K + 4 * kn, 0, kn),
            ("topk_unpack", "wrapper as the path calls it: the chunk sort and the window "
             "kernels (one histogram, as before the window groups: 58.4 / 55.2 us on an H100 "
             "80GB HBM3 at 700 W)", lambda: W.topk_unpack(vals, idx, n),
             lambda: ref.topk_unpack_ref(vals, idx, n), t_lib_unpack, 8 * m + 4 * kn, 0, 0),
            ("topk_scatter_add", "wrapper as the path calls it: the chunk sort and the "
             "window sums", lambda: W.topk_scatter_add(vals, idx, weights, n),
             lambda: ref.topk_scatter_add_ref(vals, idx, weights, n), library_scatter,
             8 * m + 4 * K + 4 * n, 0, 2 * m),
        )
        for name, variant, kernel, plain, library, nbytes, int_ops, fp_ops in cases:
            t_k, g_k = cuda_ms(torch, kernel, 50), _maybe_graph_ms(torch, kernel, 20, name)
            t_p = g_p = None
            if plain is not None:
                t_p = cuda_ms(torch, plain, 3)
                g_p = _maybe_graph_ms(torch, plain, 3, f"{name} plain")
            t_b, t_i, t_f = nbytes / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S, \
                fp_ops / FP32_OPS_PER_S
            bound_ms = max(t_b, t_i, t_f) * 1e3
            bound_by = "bytes" if t_b >= max(t_i, t_f) else "operations"
            t_l = library if isinstance(library, float) else (
                lib_ms if library is not None else None)
            log(f"[kernels] {name} {variant} {tag}: us per call eager/graph: kernel "
                f"{_us(t_k)}/{_us(g_k)}, plain {_us(t_p)}/{_us(g_p)}, library "
                f"{_us(t_l) if library is not None else 'none'}; bound {bound_ms * 1e3:.2f} us "
                f"({bound_by}: {nbytes} B, {int_ops} int32 ops, {fp_ops} fp32 ops); "
                f"eager time / bound {t_k / bound_ms:.2f}")
            if name not in rows and plain is not None:
                rows[name] = {"max_abs_err": 0.0, "ms": t_k, "plain_ms": t_p,
                              "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t_l}
    return rows


def _dispatch(mode: str) -> None:
    """Set ``lstm.scan_dispatch`` for the phases that follow (in memory)."""
    from repro_torch.profile import tuner

    tuner.registry().set_override("lstm.scan_dispatch", mode)


def phase_tiny_round(torch, mode: str):
    """One tiny FedAvg round (fp32, FVN on) on the card and on the CPU from
    the same parameters and batch, under the same LSTM dispatch (``mode``:
    'kernel' runs the encoder, S=24, through K2 on the card and its plain
    version on the CPU; FVN's noise is the normal kernel's on the card and
    its plain version's on the CPU, the same bits): the loss and the
    aggregated delta agree."""
    from repro_torch.core.engine import build_round_engine
    from repro_torch.core.plan import FederatedPlan, FVNConfig
    from repro_torch.core.task import get_task
    from repro_torch.data import FederatedSampler

    _dispatch(mode)
    task = get_task("asr-rnnt")
    plan = FederatedPlan(clients_per_round=2, local_batch_size=2, data_limit=4,
                         client_lr=0.05, server_optimizer="sgd", server_lr=1.0,
                         fvn=FVNConfig(enabled=True, std=0.01))
    params = task.init_params(torch.Generator().manual_seed(0))
    batch = FederatedSampler(task.make_corpus(0), 2, 2, data_limit=4, seed=0) \
        .next_round().engine_batch()
    out = {}
    for device in ("cuda", "cpu"):
        p = {k: v.to(device) for k, v in params.items()}
        engine = build_round_engine(plan, task, seed=1)
        state, metrics = engine.step(engine.init_state(p),
                                     {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        # server SGD with lr 1: the round's update is minus the aggregated delta
        out[device] = (metrics["loss"], {k: (p[k] - state.params[k]).cpu() for k in p})
    (loss_c, delta_c), (loss_h, delta_h) = out["cuda"], out["cpu"]
    if not math.isclose(loss_c, loss_h, rel_tol=1e-4):
        raise AssertionError(f"tiny round loss: cuda {loss_c} vs cpu {loss_h}")
    err = max(float((delta_c[k] - delta_h[k]).abs().max()) for k in delta_c)
    if err > 1e-5:
        raise AssertionError(f"tiny round aggregated delta differs by {err:.2e} (> 1e-5)")
    log(f"[tiny {mode}] loss cuda {loss_c:.6f} cpu {loss_h:.6f}; aggregated delta max|err| "
        f"{err:.2e}")


def phase_tiny_encdec_round(torch, mode: str):
    """One FedAvg round of the asr-encdec task (the reference's
    encdec-tiny, fp32, FVN on) on the card and on the CPU from the same
    parameters and batch, under the LSTM dispatch ``mode`` (the enc-dec has
    no LSTM: the round is the same under both): on the card every
    attention runs K10's CUDA-core route (head width 8) under autograd,
    three forward launches and three backward calls a client step, the
    backward on its CUDA-core route too; the loss
    and the aggregated delta agree with the CPU's plain versions."""
    from repro_torch.core.engine import build_round_engine
    from repro_torch.core.plan import FederatedPlan, FVNConfig
    from repro_torch.core.task import get_task
    from repro_torch.data import FederatedSampler

    _dispatch(mode)
    task = get_task("asr-encdec")
    K, b = 2, 2
    plan = FederatedPlan(clients_per_round=K, local_batch_size=b, data_limit=4,
                         client_lr=0.05, server_optimizer="sgd", server_lr=1.0,
                         fvn=FVNConfig(enabled=True, std=0.01))
    params = task.init_params(torch.Generator().manual_seed(0))
    rb = FederatedSampler(task.make_corpus(0), K, b, data_limit=4, seed=0).next_round()
    batch = rb.engine_batch()
    steps = K * rb.mask.shape[1]
    cfg = task.config
    calls = steps * (cfg.enc_layers + 2 * cfg.dec_layers)
    out = {}
    for device in ("cuda", "cpu"):
        p = {k: v.to(device) for k, v in params.items()}
        engine = build_round_engine(plan, task, seed=1)
        _zero_counts()
        state, metrics = engine.step(engine.init_state(p),
                                     {k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        if device == "cuda":
            _check_attn(f"[tiny encdec round {mode}]",
                        {**_k10(calls, "simt", bwd=calls), "flash_decode": 0})
        out[device] = (metrics["loss"], {k: (p[k] - state.params[k]).cpu() for k in p})
    (loss_c, delta_c), (loss_h, delta_h) = out["cuda"], out["cpu"]
    if not math.isclose(loss_c, loss_h, rel_tol=1e-4):
        raise AssertionError(f"tiny encdec round loss: cuda {loss_c} vs cpu {loss_h}")
    err = max(float((delta_c[k] - delta_h[k]).abs().max()) for k in delta_c)
    if err > 1e-5:
        raise AssertionError(f"tiny encdec round aggregated delta differs by {err:.2e} (> 1e-5)")
    log(f"[tiny encdec round {mode}] loss cuda {loss_c:.6f} cpu {loss_h:.6f}; aggregated delta "
        f"max|err| {err:.2e}; K10 {calls} forward launches and {calls} backward calls, all "
        f"on the CUDA-core routes, over {steps} client steps")


def phase_tiny_latency(torch):
    """The async engine's arrival times and staleness discount, XLA's CPU
    exp and log1p restated (ref.xla_exp_f32, ref.xla_log1p_f32): the
    latency model's times drawn from keys on the card equal the CPU's bit
    for bit (K = 256, 20 rounds' keys, two spreads), as does xla_exp_f32
    over a grid of every 4,099th float32 of [-87.8, 88.7]."""
    import numpy as np

    from repro_torch.core import keys
    from repro_torch.core.cohort import LatencyConfig, make_latency_fn
    from repro_torch.kernels import ref

    for spread in (0.25, 0.3):
        fn = make_latency_fn(LatencyConfig(enabled=True, spread=spread))
        for r in range(20):
            key = keys.fold_in(keys.PRNGKey(3), r)
            got, want = fn(key.cuda(), 256), fn(key, 256)
            if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
                raise AssertionError(f"[latency] arrival times from a key on the card differ "
                                     f"from the CPU's (spread {spread}, round {r})")
    hi = np.array([87.8, 88.7], np.float32).view(np.uint32)
    x = np.concatenate([(np.arange(0, hi[0], 4099, dtype=np.uint32) | np.uint32(0x80000000)),
                        np.arange(0, hi[1], 4099, dtype=np.uint32)]).view(np.float32)
    xt = torch.from_numpy(x)
    if not torch.equal(ref.xla_exp_f32(xt.cuda()).cpu(), ref.xla_exp_f32(xt)):
        raise AssertionError("[latency] xla_exp_f32 on the card differs from the CPU's")
    log(f"[latency] arrival times from keys on the card equal the CPU's bit for bit (K=256, 20 "
        f"keys, spreads 0.25 and 0.3); xla_exp_f32 on the card equals the CPU's on {x.size} "
        f"float32 values")


def phase_tiny_decode(torch, mode: str):
    """Greedy decoding of the tiny config (fp32) on the card and on the
    CPU from the same parameters, under the same LSTM dispatch: the token
    ids are identical."""
    from repro_torch.core.task import get_task
    from repro_torch.models import rnnt

    _dispatch(mode)
    task = get_task("asr-rnnt")
    params = task.init_params(torch.Generator().manual_seed(0))
    ev = task.make_corpus(0).eval_split(16)
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = rnnt.greedy_decode(
            task.config, {k: v.to(device) for k, v in params.items()},
            torch.from_numpy(ev["features"]).to(device),
            torch.from_numpy(ev["frame_len"]).to(device)).cpu()
    if not torch.equal(out["cuda"], out["cpu"]):
        raise AssertionError("tiny greedy decode: token ids differ between cuda and cpu")
    log(f"[tiny {mode}] greedy decode of 16 eval examples: identical token ids on cuda and cpu "
        f"({int((out['cpu'] != 0).sum())} tokens emitted)")


def phase_tiny_compressed(torch):
    """The code-domain aggregate of the same tiny deltas (the asr-rnnt
    model's shapes, K=3 clients, random from a seed) on the card and on
    the CPU under each compressed plane: bitwise equal, so the kernels and
    the plain versions agree inside the round's own data flow, leaf keys
    and all."""
    from repro_torch.core import compression as C
    from repro_torch.core import keys
    from repro_torch.core.task import get_task

    gen = torch.Generator().manual_seed(4)
    K = 3
    shapes = {n: tuple(p.shape) for n, p in get_task("asr-rnnt").model.named_parameters()}
    deltas = {n: torch.randn((K, *s), generator=gen) * 1e-3 for n, s in shapes.items()}
    ef = {n: torch.randn((K, *s), generator=gen) * 1e-4 for n, s in shapes.items()}
    n_k = torch.tensor([4.0, 2.0, 3.0])
    ckeys = keys.fold_in(keys.fold_in(keys.PRNGKey(1), 0x636D70), torch.arange(K))
    for _, _, kw, _ in COMPRESSED + (("int8", None, dict(kind="int8"), None),):
        cfg = C.CompressionConfig(**kw)
        out = {}
        for device in ("cuda", "cpu"):
            args = ({n: d.to(device) for n, d in deltas.items()}, n_k.to(device),
                    torch.ones(K, device=device), ckeys)
            if cfg.error_feedback:
                wbar, new_ef = C.code_domain_aggregate_ef(
                    cfg, *args, {n: e.to(device) for n, e in ef.items()})
            else:
                wbar, new_ef = C.code_domain_aggregate(cfg, *args), {}
            out[device] = {**{f"wbar {n}": v.cpu() for n, v in wbar.items()},
                           **{f"ef {n}": v.cpu() for n, v in new_ef.items()}}
        for name, got in out["cuda"].items():
            _bitwise(torch, got, out["cpu"][name], f"tiny aggregate {kw} {name}")
        log(f"[tiny compressed] {kw}: the aggregate{' and the residuals' if new_ef else ''} of "
            f"{len(shapes)} leaves, {K} clients: bitwise equal on cuda and cpu")
    # the fedsgd round's compress: the aggregate as one client's delta (K = 1
    # rows), the leaf keys split from the round's compression key (1, 2)
    one = {n: d[:1] for n, d in deltas.items()}
    for _, _, kw, _ in COMPRESSED + (("int8", None, dict(kind="int8"), None),):
        if kw.get("error_feedback"):
            continue  # the fedsgd engine refuses error feedback
        compress = C.make_compressor(C.CompressionConfig(**kw))
        out = {}
        for device in ("cuda", "cpu"):
            _zero_counts()
            got = compress({n: d.to(device) for n, d in one.items()}, ckeys[:1])
            out[device] = ({n: v.cpu() for n, v in got.items()}, _counts())
        for name, got in out["cuda"][0].items():
            _bitwise(torch, got, out["cpu"][0][name], f"tiny K=1 compress {kw} {name}")
        launched = {k: v for k, v in out["cuda"][1].items() if v}
        if not launched or set(launched.values()) != {len(shapes)} or any(out["cpu"][1].values()):
            raise AssertionError(f"tiny K=1 compress {kw}: launches cuda {launched}, expected "
                                 f"{len(shapes)} a kernel")
        log(f"[tiny compressed] {kw} at K=1 (the fedsgd aggregate): {len(shapes)} leaves "
            f"bitwise equal on cuda and cpu; " + ", ".join(f"{k} {v}" for k, v in launched.items())
            + " launches on the card")


def phase_tiny_slowpath(torch):
    """The slow path's server stage (``fedavg._server_stage``: compression,
    corruption, aggregation) after the drawn cohort, on the same tiny
    deltas (the asr-rnnt model's shapes, K=4 clients, random from a seed)
    on the card and on the CPU under each plane of the paper-width slow-path
    runs: bitwise equal, but for the planes that draw through ``normal``
    (the gaussian adversary, the DP noise), held to SLOW_NORMAL_TOL."""
    from repro_torch.core import fedavg, keys
    from repro_torch.core.task import get_task
    from repro_torch.launch import train

    gen = torch.Generator().manual_seed(5)
    K = 4
    shapes = {n: tuple(p.shape) for n, p in get_task("asr-rnnt").model.named_parameters()}
    deltas = {n: torch.randn((K, *s), generator=gen) * 1e-3 for n, s in shapes.items()}
    stale0 = {n: torch.randn((K, *s), generator=gen) * 1e-3 for n, s in shapes.items()}
    weight = torch.ones((K, 2, 2))
    weight[3, 1] = 0.0  # a client with one real step
    base_key = keys.PRNGKey(1)
    for name, flags, _, _ in SLOWPATH:
        plan = train.build_plan(train.parse_args(PAPER_ARGV + flags))
        plane = fedavg._plan_server_plane(plan)
        out = {}
        for r in range(2):
            ckey, qkey, akey, xkey = fedavg._plane_keys(base_key, r)
            for device in ("cuda", "cpu"):
                batch, pmask = fedavg._apply_cohort(plane, ckey, {"weight": weight.to(device)})
                n_k = fedavg._client_examples(batch)
                ckeys = fedavg._client_key_fanout(plan.compression, qkey, K)
                stale = ({n: v.to(device) for n, v in stale0.items()}
                         if plan.corruption.kind == "stale" else None)
                wbar, _, cmask, stale = fedavg._server_stage(
                    plane, {n: d.to(device) for n, d in deltas.items()}, n_k, pmask, ckeys,
                    (akey, xkey), None, stale)
                got = {f"wbar {n}": v.cpu() for n, v in wbar.items()}
                got.update({f"stale {n}": v.cpu() for n, v in (stale or {}).items()})
                got.update(pmask=pmask.cpu(), cmask=cmask.cpu(), n_k=n_k.cpu())
                out[device] = got
            normal = plan.corruption.kind == "gaussian" or plan.aggregation.dp_sigma > 0
            for what, got in out["cuda"].items():
                want = out["cpu"][what]
                if normal and what.startswith("wbar"):
                    err = float((got - want).abs().max())
                    if not err <= SLOW_NORMAL_TOL:
                        raise AssertionError(f"tiny slow path {name} round {r}: {what} "
                                             f"differs by {err:.2e} > {SLOW_NORMAL_TOL}")
                else:
                    _bitwise(torch, got, want, f"tiny slow path {name} round {r}: {what}")
            log(f"[tiny slow path] {name} round {r}: participants "
                f"{out['cpu']['pmask'].tolist()}, corrupted {out['cpu']['cmask'].tolist()}, "
                f"n_k {out['cpu']['n_k'].tolist()}: the aggregate of {len(shapes)} leaves "
                + (f"within {SLOW_NORMAL_TOL} (normal draws)" if normal else "bitwise equal")
                + " on cuda and cpu")


# the tiny ladder rounds of phase 4 (asr-rnnt, K=3, b=2, data limit 4, so
# S=2): (name, plan fields); each through the training entry point
TINY_LADDER = (
    ("fedsgd_fvn", dict(engine="fedsgd", fvn=dict(enabled=True, std=0.01)), {}),
    # the aggregate compressed at K = 1 through K5, K7's unpack and dequantize
    ("fedsgd_fvn_int4_packed_p75", dict(engine="fedsgd", fvn=dict(enabled=True, std=0.01),
                                        compression=dict(kind="int4", packed=True),
                                        cohort=dict(participation=0.75)), {}),
    ("iid", dict(fvn=dict(enabled=True, std=0.01)), dict(iid=True)),
    ("label_shuffle_50", dict(corruption=dict(kind="label_shuffle", rate=0.5)), {}),
    ("yogi_server", dict(server_optimizer="yogi", server_lr=0.01), {}),
    ("momentum_server", dict(server_optimizer="momentum", server_lr=0.5), {}),
)
TINY_PARAM_ATOL = 1e-5
# int4 stochastic rounding: the card's and the CPU's aggregates differ by
# float rounding, so a code may flip where a uniform lies within an ulp of
# the fraction it is compared with; an element may then differ by one code
# step (the leaf's largest update / 7) plus TINY_PARAM_ATOL, and at most
# TINY_FLIP_SHARE of them by more than TINY_PARAM_ATOL (tests/test_torch_fedsgd.py's rule)
TINY_FLIP_SHARE = 1e-3


def _tiny_ladder_plan(fields: dict):
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.corruption import CorruptionConfig
    from repro_torch.core.plan import CohortConfig, FederatedPlan, FVNConfig

    fields = dict(dict(server_optimizer="sgd", server_lr=1.0), **fields)
    for name, cls in (("fvn", FVNConfig), ("corruption", CorruptionConfig),
                      ("compression", CompressionConfig), ("cohort", CohortConfig)):
        if name in fields:
            fields[name] = cls(**fields[name])
    return FederatedPlan(clients_per_round=3, local_batch_size=2, data_limit=4, client_lr=0.05,
                         **fields)


def _tiny_params_err(name: str, p_c: dict, p_h: dict, params: dict, compressed: bool) -> float:
    """The largest difference of the server parameters, card against CPU;
    under a compressed plan each leaf within one code step and at most
    TINY_FLIP_SHARE of the elements past TINY_PARAM_ATOL."""
    err = flips = total = 0
    for k in p_c:
        diff = (p_c[k] - p_h[k]).abs()
        err = max(err, float(diff.max()))
        if not compressed:
            continue
        code_step = float((p_h[k] - params[k]).abs().max()) / 7
        if float(diff.max()) > code_step + TINY_PARAM_ATOL:
            raise AssertionError(f"tiny {name}: {k} differs by {float(diff.max()):.2e}, more "
                                 f"than one code step {code_step:.2e}")
        flips += int((diff > TINY_PARAM_ATOL).sum())
        total += diff.numel()
    if compressed and flips > TINY_FLIP_SHARE * total:
        raise AssertionError(f"tiny {name}: {flips} of {total} elements past {TINY_PARAM_ATOL}")
    if not compressed and err > TINY_PARAM_ATOL:
        raise AssertionError(f"tiny {name}: server parameters differ by {err:.2e} "
                             f"(> {TINY_PARAM_ATOL})")
    return err


def phase_tiny_ladder(torch):
    """The ladder's new round paths at the tiny config through the training
    entry point, on the card and on the CPU from the same parameters (K2 on
    the card, its plain version on the CPU, under 'kernel'): a fedsgd round
    with FVN on, the same with an int4 packed stochastic uplink at
    participation 0.75, an IID round, a label-shuffle round at rate 0.5,
    and rounds with a yogi and a momentum server. Held at the tiny round's
    tolerances: the loss to 1e-4 relative, the server parameters to
    TINY_PARAM_ATOL (under int4, to one code step for at most
    TINY_FLIP_SHARE of the elements)."""
    from repro_torch.core.task import FederatedTask, get_task
    from repro_torch.launch import train

    _dispatch("kernel")
    tiny = get_task("asr-rnnt")
    params = tiny.init_params(torch.Generator().manual_seed(0))

    class FixedInit(FederatedTask):
        """The tiny task, its parameters drawn once on the CPU."""

        def init_params(self, generator):
            return {k: v.to(generator.device) for k, v in params.items()}

    task = FixedInit(tiny.name, tiny.config, tiny.make_corpus)
    corpus = task.make_corpus(0)
    for name, fields, kw in TINY_LADDER:
        plan = _tiny_ladder_plan(fields)
        out = {}
        for device in ("cuda", "cpu"):
            _zero_counts()
            state, hist = train.run_federated(task, corpus, plan, 1, device=device,
                                              eval_examples=0, log=lambda line: None, **kw)
            out[device] = (hist, {k: v.cpu() for k, v in state.params.items()}, _counts())
        (h_c, p_c, n_c), (h_h, p_h, n_h) = out["cuda"], out["cpu"]
        loss_c, loss_h = h_c["loss"], h_h["loss"]
        if not all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(loss_c, loss_h)):
            raise AssertionError(f"tiny {name}: loss cuda {loss_c} vs cpu {loss_h}")
        compressed = plan.compression.kind != "none"
        err = _tiny_params_err(name, p_c, p_h, params, compressed)
        moved = max(float((p_h[k] - params[k]).abs().max()) for k in p_h)
        if not moved > 0:
            raise AssertionError(f"tiny {name}: the server parameters did not move")
        for k in ("corrupted_total", "participants_mean", "uplink_bytes_total"):
            if h_c[k] != h_h[k]:
                raise AssertionError(f"tiny {name}: {k} cuda {h_c[k]} vs cpu {h_h[k]}")
        if (name == "label_shuffle_50") != (h_h["corrupted_total"] > 0):
            raise AssertionError(f"tiny {name}: corrupted clients {h_h['corrupted_total']}")
        if compressed:
            n_leaves = len(p_c)
            # the compress ran on the card's kernels once a leaf, on the CPU on none
            if any(n_c[k] != n_leaves for k in FEDSGD_WIRE) or any(n_h[k] for k in FEDSGD_WIRE):
                raise AssertionError(f"tiny {name}: wire launches cuda "
                                     f"{ {k: n_c[k] for k in FEDSGD_WIRE} } (expected "
                                     f"{n_leaves} each), cpu { {k: n_h[k] for k in FEDSGD_WIRE} }")
            if not h_h["participants_mean"] < plan.clients_per_round:
                raise AssertionError(f"tiny {name}: the drawn cohort dropped no client")
        log(f"[tiny ladder] {name}: loss cuda {loss_c[0]:.6f} cpu {loss_h[0]:.6f}; server "
            f"parameters max|err| {err:.2e} (moved up to {moved:.2e}); participants "
            f"{h_h['participants_mean']}, corrupted {h_h['corrupted_total']}"
            + (f"; {', '.join(FEDSGD_WIRE)} {len(p_c)} launches each on the card"
               if compressed else ""))


class _RoundTap:
    """Wraps the round engine's round body (the fedavg engine's, or with
    ``engine="async"`` the async engine's wave): keeps each round's
    metrics and, with ``keep_params``, the server parameters after it,
    which ``snapshot`` copies to the host outside the round's timing."""

    BODIES = {"fedavg": ("repro_torch.core.fedavg", "_fedavg_round_body"),
              "async": ("repro_torch.core.async_engine", "_async_round_body")}

    def __init__(self, keep_params: bool, engine: str = "fedavg"):
        import importlib

        module, self.name = self.BODIES[engine]
        self.owner = importlib.import_module(module)
        self.keep, self.metrics, self.params = keep_params, [], []
        self.saved, self.pending = getattr(self.owner, self.name), None

    def __enter__(self):
        def tapped(*args, **kwargs):
            state, metrics = self.saved(*args, **kwargs)
            self.metrics.append(metrics)
            self.pending = state.params if self.keep else None
            return state, metrics

        setattr(self.owner, self.name, tapped)
        return self

    def snapshot(self) -> None:
        if self.pending is not None:
            self.params.append({k: v.detach().cpu() for k, v in self.pending.items()})
            self.pending = None

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.saved)


class _RunWatch:
    """The log callback of a counted paper-width run: after each round the
    launch counts and the peak memory so far; the last round under
    torch.profiler (started after the round before it), the rounds before
    it unprofiled; with a ``tap``, its snapshot outside the rounds."""

    def __init__(self, torch, tag: str, rounds: int, tap=None):
        from torch.profiler import ProfilerActivity, profile

        self.torch, self.tag, self.rounds, self.tap = torch, tag, rounds, tap
        self.prof = profile(activities=[ProfilerActivity.CUDA])  # device events only
        self.marks = []

    def __call__(self, line: str) -> None:
        log(f"{self.tag} {line}")
        self.marks.append((_counts(), self.torch.cuda.max_memory_allocated()))
        if len(self.marks) == self.rounds:
            self.torch.cuda.synchronize()
            self.prof.stop()
        if self.tap is not None:
            self.tap.snapshot()
        if len(self.marks) == self.rounds - 1:
            self.prof.start()

    def check_launches(self, want: dict) -> None:
        """Every round launched exactly ``want`` of each kernel."""
        prev = {k: 0 for k in want}
        for r, (mark, _) in enumerate(self.marks):
            got = {k: mark[k] - prev[k] for k in want}
            if got != want:
                raise AssertionError(f"{self.tag} launches in round {r + 1} {got}, expected "
                                     f"{want}")
            prev = mark


def _device_times(torch, prof) -> dict:
    """{kernel name: (device microseconds, launches)} of a profiler run."""
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    return by_name


# substrings of the hand-written kernels' names, and of the plane's among them
_OURS = ("lstm_gates", "lstm_scan", "joint_", "flash_attention", "fa_bwd_", "flash_decode",
         "threefry_normal", "wkv6_", "ssm_scan_")
_WIRE = ("wire_quantize", "nibble_", "dequantize_kernel", "topk_scatter_add", "topk_unpack")


def _log_profile(tag: str, by_name: dict, round_s: float, profiled_s: float,
                 plane_ms=None, what: str = "round") -> None:
    """The busy share of a profiled round (its device kernel time against
    the unprofiled ``round_s`` and the profiled round's own wall time),
    the kernels that fill it, and with ``plane_ms`` (the plane's span in
    CUDA events in the profiled round) the plane's share."""
    if not by_name:
        log(f"{tag} the profiler recorded no device events: busy share not measured")
        return
    device_s = sum(t for t, _ in by_name.values()) / 1e6
    log(f"{tag} one {what}: device kernel time {device_s * 1e3:.1f} ms, "
        f"{sum(n for _, n in by_name.values())} device events; busy share "
        f"{device_s / round_s:.3f} of the unprofiled {what} ({round_s * 1e3:.1f} ms), "
        f"{device_s / profiled_s:.3f} of the profiled one ({profiled_s * 1e3:.1f} ms)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    ours = [kv for kv in ranked if any(k in kv[0] for k in _OURS + _WIRE)]
    for name, (t, n) in ranked[:8] + [kv for kv in ours if kv not in ranked[:8]]:
        log(f"{tag}   {t / 1e3:9.2f} ms  {t / 1e6 / device_s:6.3f}  {n:6d}x  {name[:100]}")
    share = sum(t for _, (t, _) in ours) / 1e6 / device_s
    log(f"{tag} the hand-written kernels' share of device time: {share:.3f}")
    if plane_ms is not None:
        wire_s = sum(t for name, (t, _) in ranked if any(k in name for k in _WIRE)) / 1e6
        log(f"{tag} the server plane: {plane_ms:.3f} ms on the device between its events "
            f"({plane_ms / 1e3 / device_s:.4f} of the round's device kernel time, profiled), "
            f"of which its hand-written kernels {wire_s * 1e3:.3f} ms ({wire_s / device_s:.4f})")


def _k2_launches(cfg, steps: int) -> dict:
    """A K2 round's launches over ``steps`` client steps: each K2 kernel
    once a layer, each joint kernel and the normal kernel (FVN) once."""
    layers = cfg.enc_layers + cfg.pred_layers
    return dict(lstm_scan_fwd=layers * steps, lstm_scan_bwd_gates=layers * steps,
                lstm_scan_bwd=layers * steps, lstm_scan_dw=layers * steps,
                **{k: steps for k in JOINT_KERNELS}, threefry_normal=steps)


def phase_paper_slowpath(torch, name: str, flags, uplink: int, kernels, loss_ref: float,
                         keep_params: bool = False, params_ref=None):
    """FedAvg rounds of rnnt-librispeech on the slow path (a robust
    aggregator or a delta adversary), on the K2 path with the fused joint,
    through the training entry point, with no evaluation: two counted
    rounds, then a third under torch.profiler for the busy share. The
    counts are set to 0 before the run and read after each round: each
    plane kernel of the run once per leaf a round, K2 and the joint
    kernels as uncompressed. The uplink per reporting client is exact, the
    first-round loss of a full cohort is the uncompressed run's
    ``loss_ref``, and with ``params_ref`` (another run's server parameters
    after each round) the parameters are equal bit for bit. Returns
    ({kernel: launches over the run}, [server parameters after each round,
    on the host, with ``keep_params`` or ``params_ref``])."""
    from repro_torch.launch import train

    _dispatch("auto")
    task = _paper_task(True)
    cfg, rounds = task.config, 3
    corpus = task.make_corpus(0)
    args = train.parse_args(PAPER_ARGV + ["--rounds", str(rounds)] + flags)
    plan = train.build_plan(args)
    tag = f"[paper slow path {name}]"
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with _PlaneTimer(torch, _PlaneTimer.SLOW) as timer, \
            _RoundTap(keep_params or params_ref is not None) as tap:
        watch = _RunWatch(torch, tag, rounds, tap)
        _, hist = train.run_federated(task, corpus, plan, rounds, seed=args.seed, device="cuda",
                                      eval_every=0, eval_examples=0, log=watch)
    spans = timer.ms()
    plane_ms = [spans[2 * r] + spans[2 * r + 1] for r in range(rounds)]
    steps = args.clients * hist["local_steps"]  # client steps per round
    want = {k: 0 for k in watch.marks[0][0]}
    want.update(_k2_launches(cfg, steps))
    # the normal kernel: FVN a step; the gaussian adversary and the DP noise a round
    want["threefry_normal"] += ((plan.corruption.kind == "gaussian")
                                + (plan.aggregation.dp_sigma > 0))
    want.update({k: N_LEAVES for k in kernels})
    watch.check_launches(want)
    participants = [m["participants"] for m in tap.metrics]
    corrupted = [m["corrupted"] for m in tap.metrics]
    if hist["uplink_bytes_client"] != uplink:
        raise AssertionError(f"{tag} uplink bytes per reporting client "
                             f"{hist['uplink_bytes_client']}, expected {uplink}")
    if hist["uplink_bytes_total"] != uplink * sum(participants):
        raise AssertionError(f"{tag} uplink total {hist['uplink_bytes_total']} for "
                             f"participants {participants}")
    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"{tag} losses are not finite: {hist['loss']}")
    if params_ref is not None:
        for r, (got, ref_params) in enumerate(zip(tap.params, params_ref)):
            bad = [k for k in got if not torch.equal(got[k], ref_params[k])]
            if bad:
                err = max(float((got[k] - ref_params[k]).abs().max()) for k in bad)
                raise AssertionError(f"{tag} server parameters after round {r + 1} differ "
                                     f"from the packed run's in {len(bad)} tensors, by up to "
                                     f"{err:.3e}: {bad[:4]}")
        log(f"{tag} server parameters after each of {len(tap.params)} rounds equal the packed "
            "run's bit for bit")
    per_s = [e / s for e, s in zip(hist["examples"], hist["round_s"])]
    log(f"{tag} {plan.cohort}, {plan.compression}, {plan.aggregation}, {plan.corruption}, "
        f"latency {plan.latency.enabled}: losses {hist['loss']}; ms per round "
        f"{[round(x * 1e3, 1) for x in hist['round_s']]} (round 3 profiled); client examples "
        f"per second {per_s}; participants {participants}; corrupted {corrupted}; simulated "
        f"seconds {[m['sim_time_s'] for m in tap.metrics]}; server plane (cohort, then "
        f"compression, corruption and aggregation) ms per round, CUDA events "
        f"{[round(x, 3) for x in plane_ms]}; peak memory over rounds 1 and 2 "
        f"{watch.marks[1][1]} B; uplink {uplink} B per reporting client, "
        f"{hist['wire_bytes_total']} B on the wire; launches per round: "
        + (", ".join(f"{k} {N_LEAVES}" for k in kernels) or "no plane kernel"))
    _log_profile(tag, _device_times(torch, watch.prof), hist["round_s"][1], hist["round_s"][2],
                 plane_ms[2])
    if plan.cohort.full and hist["loss"][0] != loss_ref:
        raise AssertionError(f"{tag} first-round loss {hist['loss'][0]!r} is not the "
                             f"uncompressed run's {loss_ref!r}")
    return watch.marks[-1][0], tap.params


def _paper_task(use_kernel: bool, enc_layers=None):
    from repro_torch.configs import rnnt_librispeech
    from repro_torch.core.task import get_task

    task = get_task(rnnt_librispeech.ARCH_ID)
    cfg = dataclasses.replace(task.config, use_kernel=use_kernel)
    if enc_layers is not None:
        cfg = dataclasses.replace(cfg, enc_layers=enc_layers)
    return dataclasses.replace(task, config=cfg)


def _counts():
    from repro_torch.kernels import lstm_gates as K1
    from repro_torch.kernels import lstm_scan as K2
    from repro_torch.kernels import rnnt_joint as KJ
    from repro_torch.kernels import threefry_normal as KN
    from repro_torch.kernels import wire_pack as KW

    return {"threefry_normal": KN.NORMAL_LAUNCHES, "wire_quantize": KW.QUANTIZE_LAUNCHES,
            "nibble_pack": KW.PACK_LAUNCHES,
            "nibble_unpack": KW.UNPACK_LAUNCHES, "dequantize": KW.DEQUANTIZE_LAUNCHES,
            "topk_scatter_add": KW.SCATTER_ADD_LAUNCHES,
            "topk_scatter_add_sort": KW.SCATTER_ADD_SORT_LAUNCHES,
            "topk_scatter_add_sum": KW.SCATTER_ADD_SUM_LAUNCHES,
            "topk_unpack": KW.TOPK_UNPACK_LAUNCHES,
            "lstm_gates_fwd": K1.FWD_LAUNCHES, "lstm_gates_bwd": K1.BWD_LAUNCHES,
            "lstm_scan_fwd": K2.SCAN_FWD_LAUNCHES,
            "lstm_scan_bwd_gates": K2.SCAN_BWD_GATES_LAUNCHES,
            "lstm_scan_bwd": K2.SCAN_BWD_LAUNCHES, "lstm_scan_dw": K2.SCAN_DW_LAUNCHES,
            "rnnt_joint_fwd": KJ.FWD_LAUNCHES, "rnnt_joint_fwd_h": KJ.FWD_H_LAUNCHES,
            "rnnt_joint_fwd_logits": KJ.FWD_LOGITS_LAUNCHES,
            "rnnt_joint_fwd_lse": KJ.FWD_LSE_LAUNCHES, "rnnt_joint_bwd_h": KJ.BWD_H_LAUNCHES,
            "rnnt_joint_bwd_dlogits": KJ.BWD_DLOGITS_LAUNCHES,
            "rnnt_joint_bwd_dh": KJ.BWD_DH_LAUNCHES,
            "rnnt_joint_bwd_reduce": KJ.BWD_REDUCE_LAUNCHES,
            "rnnt_joint_bwd_dw": KJ.BWD_DW_LAUNCHES, **_attn_counts(), **_wide_counts(),
            **_recurrence_counts()}


def _recurrence_counts() -> dict:
    from repro_torch.kernels import ssm_scan as K13
    from repro_torch.kernels import wkv6 as K12

    return {"wkv6_fwd": K12.FWD_LAUNCHES, "wkv6_bwd": K12.BWD_LAUNCHES,
            "ssm_scan_fwd": K13.FWD_LAUNCHES, "ssm_scan_bwd": K13.BWD_LAUNCHES}


def _zero_counts() -> None:
    from repro_torch.kernels import lstm_gates as K1
    from repro_torch.kernels import lstm_scan as K2
    from repro_torch.kernels import rnnt_joint as KJ

    from repro_torch.kernels import threefry_normal as KN
    from repro_torch.kernels import wire_pack as KW

    KN.NORMAL_LAUNCHES = 0
    KW.QUANTIZE_LAUNCHES = KW.PACK_LAUNCHES = KW.UNPACK_LAUNCHES = KW.SCATTER_ADD_LAUNCHES = 0
    KW.DEQUANTIZE_LAUNCHES = KW.TOPK_UNPACK_LAUNCHES = 0
    KW.SCATTER_ADD_SORT_LAUNCHES = KW.SCATTER_ADD_SUM_LAUNCHES = 0
    K1.FWD_LAUNCHES = K1.BWD_LAUNCHES = 0
    K2.SCAN_FWD_LAUNCHES = K2.SCAN_BWD_GATES_LAUNCHES = K2.SCAN_BWD_LAUNCHES = 0
    K2.SCAN_DW_LAUNCHES = 0
    KJ.FWD_LAUNCHES = KJ.FWD_H_LAUNCHES = KJ.FWD_LOGITS_LAUNCHES = KJ.FWD_LSE_LAUNCHES = 0
    KJ.BWD_H_LAUNCHES = KJ.BWD_DLOGITS_LAUNCHES = KJ.BWD_DH_LAUNCHES = 0
    KJ.BWD_REDUCE_LAUNCHES = KJ.BWD_DW_LAUNCHES = 0
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KA

    KA.FWD_LAUNCHES = KA.WGMMA_LAUNCHES = KA.SIMT_LAUNCHES = KD.FWD_LAUNCHES = 0
    KA.BWD_LAUNCHES = KA.BWD_WGMMA_LAUNCHES = KA.BWD_SIMT_LAUNCHES = 0
    KA.WGMMA_WIDE_LAUNCHES = KA.SIMT_WIDE_LAUNCHES = KD.WIDE_LAUNCHES = 0
    KA.BWD_WGMMA_WIDE_LAUNCHES = KA.BWD_SIMT_WIDE_LAUNCHES = 0
    from repro_torch.kernels import ssm_scan as K13
    from repro_torch.kernels import wkv6 as K12

    K12.FWD_LAUNCHES = K12.BWD_LAUNCHES = K13.FWD_LAUNCHES = K13.BWD_LAUNCHES = 0


def phase_paper_width(torch, use_kernel: bool, mode: str, enc_layers=None):
    """Two FedAvg rounds of rnnt-librispeech through the training entry
    point under ``lstm.scan_dispatch`` = ``mode``, then its final
    evaluation. The counts are set to 0 before the run, read after the
    last round (training) and again at the end (the evaluation), and must
    be exact: under 'ref' every LSTM step is a K1 launch; under 'auto'
    every layer is one K2 launch of each kernel, and only the decoder's
    per-step predictor runs K1. Returns ({kernel: launches over the whole
    run}, the last round's seconds, the first round's loss, the server
    parameters after the last round on the host)."""
    from repro_torch.launch import train
    from repro_torch.models.lstm import _scan_kernel_eligible

    _dispatch(mode)
    task = _paper_task(use_kernel, enc_layers)
    cfg, rounds = task.config, 2
    corpus = task.make_corpus(0)
    args = train.parse_args(PAPER_ARGV + ["--rounds", str(rounds)])
    tag = f"[paper {mode} use_kernel={use_kernel} enc_layers={cfg.enc_layers}]"
    t_enc = corpus.t_max // cfg.time_stride
    scan = {S: _scan_kernel_eligible(S, cfg.enc_hidden, cfg.scan_chunk, torch.device("cuda"))
            for S in (t_enc, corpus.u_max + 1)}
    if set(scan.values()) != {mode == "auto"}:
        raise AssertionError(f"{tag} the dispatch rule gives {scan} (sequence length: K2?)")
    marks = []

    def after_round(line):
        log(f"{tag} {line}")
        marks.append((_counts(), torch.cuda.max_memory_allocated()))

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, hist = train.run_federated(task, corpus, train.build_plan(args), rounds,
                                      seed=args.seed, device="cuda", eval_every=args.eval_every,
                                      eval_examples=EVAL_EXAMPLES, log=after_round)
    torch.cuda.synchronize()
    total = _counts()
    trained, train_peak = marks[-1]
    evaluated = {k: total[k] - trained[k] for k in total}

    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"{tag} losses are not finite: {hist['loss']}")
    steps = args.clients * hist["local_steps"] * rounds
    layers = cfg.enc_layers + cfg.pred_layers
    loop_steps = cfg.enc_layers * t_enc + cfg.pred_layers * (corpus.u_max + 1)
    joint = steps if use_kernel else 0  # one launch of each joint kernel per client step
    want = {k: 0 for k in total}
    want.update({k: joint for k in JOINT_KERNELS}, threefry_normal=steps)  # FVN: 1 a step
    if mode == "auto":
        want.update(lstm_scan_fwd=layers * steps, lstm_scan_bwd_gates=layers * steps,
                    lstm_scan_bwd=layers * steps, lstm_scan_dw=layers * steps)
    else:
        want.update(lstm_gates_fwd=loop_steps * steps, lstm_gates_bwd=loop_steps * steps)
    if trained != want:
        raise AssertionError(f"{tag} launches over the training rounds {trained}, expected "
                             f"{want} ({steps} client steps)")
    pred_steps = cfg.pred_layers * (1 + t_enc * 4)  # the decoder's predictor, per decode
    want_eval = {k: 0 for k in total}
    if mode == "auto":
        want_eval.update(lstm_scan_fwd=2 * cfg.enc_layers, lstm_gates_fwd=2 * pred_steps)
    else:
        want_eval.update(lstm_gates_fwd=2 * (cfg.enc_layers * t_enc + pred_steps))
    if evaluated != want_eval:
        raise AssertionError(f"{tag} launches over the evaluation {evaluated}, expected "
                             f"{want_eval}")
    if mode == "auto" and use_kernel and enc_layers is None:
        if K2_ROUND_LOSSES is None:
            log(f"{tag} losses {hist['loss']} (K2_ROUND_LOSSES not set yet)")
        elif tuple(hist["loss"]) != K2_ROUND_LOSSES:
            raise AssertionError(f"{tag} losses {hist['loss']} are not K2_ROUND_LOSSES "
                                 f"{list(K2_ROUND_LOSSES)} bit for bit")
        else:
            log(f"{tag} losses {hist['loss']} equal K2_ROUND_LOSSES bit for bit")
    wers = (hist["quality"], hist["quality_hard"])
    if not all(math.isfinite(x) and x >= 0 for x in wers):
        raise AssertionError(f"{tag} WER is not a finite non-negative number: {wers}")
    per_s = [e / s for e, s in zip(hist["examples"], hist["round_s"])]
    log(f"{tag} {hist['n_params']} parameters; losses {hist['loss']}; "
        f"ms per round {[round(s * 1e3, 1) for s in hist['round_s']]}; "
        f"client examples per second {per_s}; peak memory over the training rounds "
        f"{train_peak} B")
    log(f"{tag} launches per client step over {steps} client steps: "
        + ", ".join(f"{k} {v / steps:g}" for k, v in trained.items() if v))
    log(f"{tag} final evaluation ({EVAL_EXAMPLES} examples of each split): "
        f"{hist['eval_s'] * 1e3:.1f} ms, WER {wers[0]:.4f} clean, {wers[1]:.4f} hard; "
        f"launches {({k: v for k, v in evaluated.items() if v})} (2 decodes); "
        f"peak memory {torch.cuda.max_memory_allocated()} B")
    return (total, hist["round_s"][-1], hist["loss"][0],
            {k: v.detach().cpu() for k, v in state.params.items()})


class _PlaneTimer:
    """CUDA events around functions of the round engine (``core/fedavg.py``),
    one pair a call; read after the run, which has synchronised. By default
    the code-domain aggregate (the whole compressed plane of the fast path:
    scales, keys, kernels, sums, top-k); for the slow path the cohort and
    the server stage (compression, corruption, aggregation)."""

    FAST = ("code_domain_aggregate", "code_domain_aggregate_ef")
    SLOW = ("_apply_cohort", "_server_stage")

    def __init__(self, torch, names=FAST):
        from repro_torch.core import fedavg

        self.torch, self.fedavg, self.names, self.pairs = torch, fedavg, names, []
        self.saved = {name: getattr(fedavg, name) for name in names}

    def _wrap(self, fn):
        def timed(*args):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            self.pairs.append((start, end))
            return out
        return timed

    def __enter__(self):
        for name, fn in self.saved.items():
            setattr(self.fedavg, name, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.fedavg, name, fn)

    def ms(self) -> list:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs]


def _compressed_plan(args, kw: dict):
    """The plan the CLI flags build, with the compression they cannot
    say (nearest rounding) set as a user of run_federated would."""
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.launch import train

    plan = train.build_plan(args)
    want = CompressionConfig(**kw)
    if plan.compression != want:
        plan = dataclasses.replace(plan, compression=want)
    return plan


def phase_paper_compressed(torch, name: str, flags, kw: dict, uplink: int, loss_ref: float):
    """FedAvg rounds of rnnt-librispeech on the K2 path with the fused
    joint (``lstm.scan_dispatch=auto``, ``use_kernel=True``) and a
    compressed uplink, through the training entry point, with no final
    evaluation: two counted rounds, then a third under torch.profiler for
    the busy share and the compression plane's share. The counts are set
    to 0 before the run and read after each round: every round launches
    each of the plane's kernels once per leaf, K2 and the joint kernels as
    uncompressed. The uplink per client is exact, and the first-round loss
    (computed before any compression) equals the uncompressed run's
    ``loss_ref``. Returns {kernel: launches over the run}."""
    from repro_torch.launch import train

    _dispatch("auto")
    task = _paper_task(True)
    cfg, rounds = task.config, 3
    corpus = task.make_corpus(0)
    args = train.parse_args(PAPER_ARGV + ["--rounds", str(rounds)] + flags)
    plan = _compressed_plan(args, kw)
    tag = f"[paper compressed {name}]"
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    watch = _RunWatch(torch, tag, rounds)
    with _PlaneTimer(torch) as timer:
        _, hist = train.run_federated(task, corpus, plan, rounds, seed=args.seed, device="cuda",
                                      eval_every=0, eval_examples=0, log=watch)
    plane_ms = timer.ms()
    want = {k: 0 for k in watch.marks[0][0]}
    want.update(_k2_launches(cfg, args.clients * hist["local_steps"]))
    want.update({k: N_LEAVES for k in WIRE_LAUNCHES[name]})
    watch.check_launches(want)
    if hist["uplink_bytes_client"] != uplink:
        raise AssertionError(f"{tag} uplink bytes per client {hist['uplink_bytes_client']}, "
                             f"expected {uplink}")
    if hist["uplink_bytes_total"] != uplink * args.clients * rounds:
        raise AssertionError(f"{tag} uplink total {hist['uplink_bytes_total']}")
    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"{tag} losses are not finite: {hist['loss']}")
    if hist["loss"][0] != loss_ref:
        raise AssertionError(f"{tag} first-round loss {hist['loss'][0]!r} is not the "
                             f"uncompressed run's {loss_ref!r}")
    per_s = [e / s for e, s in zip(hist["examples"], hist["round_s"])]
    log(f"{tag} {plan.compression}: losses {hist['loss']} (round 1 equal to the uncompressed "
        f"run's); ms per round {[round(x * 1e3, 1) for x in hist['round_s']]} (round 3 "
        f"profiled); client examples per second {per_s}; compression plane ms per round (CUDA "
        f"events) {[round(x, 3) for x in plane_ms]}; peak memory over rounds 1 and 2 "
        f"{watch.marks[1][1]} B; uplink {uplink} B per client, {hist['wire_bytes_total']} B on "
        f"the wire; launches per round: "
        + ", ".join(f"{k} {v}" for k, v in want.items() if v and k in WIRE_KERNELS))
    _log_profile(tag, _device_times(torch, watch.prof), hist["round_s"][1], hist["round_s"][2],
                 plane_ms[2])
    return watch.marks[-1][0]


# the experiment ladder's paper-width runs of phase 5, each on K2 with the
# fused joint, K=4, b=4, two rounds: (name, CLI flags after PAPER_ARGV, or
# None for a plan of core/experiments.py's ladder)
PAPER_LADDER = (
    ("e0_iid", None),
    ("e10_specaug2", None),
    ("label_shuffle_50", ["--corrupt-kind", "label_shuffle", "--corrupt-rate", "0.5"]),
    ("fedsgd", ["--engine", "fedsgd"]),
    ("fedsgd_int4_packed", ["--engine", "fedsgd", "--compression", "int4", "--packed-wire"]),
)
# the plane kernels the compressed fedsgd round launches once per leaf: the
# aggregate compressed as one client's delta, packed, unpacked, dequantized
FEDSGD_WIRE = ("wire_quantize", "nibble_unpack", "dequantize")


class _Tap:
    """Wraps ``owner.name`` while the context is open: each call's
    arguments and result go to ``record``."""

    def __init__(self, owner, name: str, record):
        self.owner, self.name, self.record = owner, name, record
        self.saved = getattr(owner, name)

    def __enter__(self):
        saved, record = self.saved, self.record

        def tapped(*args, **kwargs):
            out = saved(*args, **kwargs)
            record(args, out)
            return out

        setattr(self.owner, self.name, tapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.saved)


def phase_paper_ladder(torch, name: str, flags):
    """Two rounds of rnnt-librispeech on K2 with the fused joint through
    the training entry point, under one of the ladder's new paths: the E0
    plan of ``ladder(clients_per_round=4, local_batch_size=4)`` with
    local_steps=2 under ``iid=True`` (with the final evaluation), E10's
    plan under ``specaug_scale=2.0``, the label-shuffle adversary at rate
    0.5, the fedsgd engine, and the fedsgd engine with an int4 packed
    uplink. The counts are set to 0 before the run and read after each
    round and after the evaluation, and must be exact: a fedavg round
    launches each K2 kernel once a layer, each joint kernel and the normal
    kernel once a client step, as the K2 run does; a fedsgd round once for
    its one step, and with int4 each of FEDSGD_WIRE once per leaf. Returns
    ({kernel: launches over the run}, the last round's seconds)."""
    from repro_torch.core.experiments import ladder
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models import rnnt

    _dispatch("auto")
    task = _paper_task(True)
    cfg, rounds = task.config, 2
    corpus = task.make_corpus(0)
    args = train.parse_args(PAPER_ARGV + ["--rounds", str(rounds)] + (flags or []))
    plan, kw, eval_examples = train.build_plan(args), {}, 0
    tag = f"[paper ladder {name}]"
    if name == "e0_iid":
        plan = dataclasses.replace(ladder(clients_per_round=4, local_batch_size=4)["E0"],
                                   local_steps=2)
        kw, eval_examples = dict(iid=True), EVAL_EXAMPLES
    elif name == "e10_specaug2":
        plan = ladder(clients_per_round=4, local_batch_size=4, data_limit=8)["E10"]
        kw = dict(specaug_scale=2.0)
    marks, n_k, shuffled, masks = [], [], [], []

    def after_round(line):
        log(f"{tag} {line}")
        marks.append((_counts(), torch.cuda.max_memory_allocated()))

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with _Tap(train, "pack_round", lambda a, rb: n_k.append(rb.n_k.tolist())), \
            _Tap(pipeline.FederatedSampler, "next_round",
                 lambda a, rb: shuffled.append(a[0].corrupted_counts[-1:])), \
            _Tap(rnnt, "spec_augment",
                 lambda a, out: masks.append((a[2].freq_masks, a[2].time_masks))):
        _, hist = train.run_federated(task, corpus, plan, rounds, seed=args.seed, device="cuda",
                                      eval_every=0, eval_examples=eval_examples,
                                      log=after_round, **kw)
    torch.cuda.synchronize()
    total = _counts()
    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"{tag} losses are not finite: {hist['loss']}")
    fedsgd = plan.engine == "fedsgd"
    steps = 1 if fedsgd else plan.clients_per_round * hist["local_steps"]  # a round's
    want = {k: 0 for k in total}
    want.update(_k2_launches(cfg, steps))
    if plan.compression.kind != "none":
        want.update({k: N_LEAVES for k in FEDSGD_WIRE})
    prev = {k: 0 for k in total}
    for r, (mark, _) in enumerate(marks):
        got = {k: mark[k] - prev[k] for k in total}
        if got != want:
            raise AssertionError(f"{tag} launches in round {r + 1} {got}, expected {want}")
        prev = mark
    evaluated = {k: total[k] - prev[k] for k in total}
    t_enc = corpus.t_max // cfg.time_stride
    want_eval = {k: 0 for k in total}
    if eval_examples:
        want_eval.update(lstm_scan_fwd=2 * cfg.enc_layers,
                         lstm_gates_fwd=2 * cfg.pred_layers * (1 + t_enc * 4))
        wers = (hist["quality"], hist["quality_hard"])
        if not all(math.isfinite(x) and x >= 0 for x in wers):
            raise AssertionError(f"{tag} WER is not a finite non-negative number: {wers}")
        log(f"{tag} final evaluation ({eval_examples} examples of each split): "
            f"{hist['eval_s'] * 1e3:.1f} ms, WER {wers[0]:.4f} clean, {wers[1]:.4f} hard")
    if evaluated != want_eval:
        raise AssertionError(f"{tag} launches over the evaluation {evaluated}, expected "
                             f"{want_eval}")
    # the masks of every client step's SpecAugment in the run: E10's scale
    # doubles the config's 2 and 2
    want_masks = (4, 4) if name == "e10_specaug2" else (cfg.specaug.freq_masks,
                                                        cfg.specaug.time_masks)
    if len(masks) != steps * rounds or set(masks) != {want_masks}:
        raise AssertionError(f"{tag} SpecAugment ran {len(masks)} times (expected "
                             f"{steps * rounds}) with (frequency, time) masks {set(masks)}, "
                             f"expected {want_masks}")
    if name == "e10_specaug2":
        log(f"{tag} SpecAugment ran {len(masks)} times in the run, each with 4 frequency and "
            f"4 time masks")
    if name == "e0_iid" and (len(n_k) != rounds or any(n != [8.0] * 4 for n in n_k)):
        raise AssertionError(f"{tag} the IID rounds' n_k {n_k}, expected 8 for each client")
    if hist["participants_mean"] != plan.clients_per_round:
        raise AssertionError(f"{tag} participants {hist['participants_mean']}")
    if name == "label_shuffle_50":
        host = pipeline.FederatedSampler(
            task.make_corpus(0), clients_per_round=args.clients, local_batch_size=args.batch,
            data_limit=args.data_limit, seed=args.seed, label_shuffle_rate=0.5)
        for _ in range(rounds):
            host.next_round()
        got = [c for counts in shuffled for c in counts]
        if got != host.corrupted_counts or hist["corrupted_total"] != sum(got):
            raise AssertionError(f"{tag} corrupted clients a round {got} (total "
                                 f"{hist['corrupted_total']}), the host sampler's "
                                 f"{host.corrupted_counts}")
        log(f"{tag} corrupted clients a round {got}, equal to a second host sampler's from "
            f"seed {args.seed}")
    if plan.compression.kind != "none":
        uplink = COMPRESSED[0][3]  # int4 packed, per reporting client
        if hist["uplink_bytes_client"] != uplink or \
                hist["uplink_bytes_total"] != uplink * args.clients * rounds:
            raise AssertionError(f"{tag} uplink {hist['uplink_bytes_client']} B per client, "
                                 f"{hist['uplink_bytes_total']} B in all; expected {uplink} "
                                 "per client")
    per_s = [e / t for e, t in zip(hist["examples"], hist["round_s"])]
    log(f"{tag} engine {plan.engine}, {plan.compression.kind} uplink, "
        f"{steps} forward/backward a round: losses {hist['loss']}; ms per round "
        f"{[round(x * 1e3, 1) for x in hist['round_s']]}; client examples per second {per_s}; "
        f"peak memory over the training rounds {marks[-1][1]} B; uplink "
        f"{hist['uplink_bytes_client']} B per client; launches per round: "
        + ", ".join(f"{k} {v}" for k, v in want.items() if v))
    return total, hist["round_s"][-1]


# the async engine's paper-width runs of phase 5 (PAPER_ARGV: K=4, b=4, 2
# local steps, FVN 0.01; K2 with the fused joint): the sync-parity plane
# (B = K, one device tier, no jitter) over 2 waves, then a buffer of 3 that
# does not divide K, with the staleness discount, the latency model and an
# int4 packed uplink, over 3 waves
ASYNC_PARITY_ARGV = ["--engine", "async", "--buffer-size", "4"]
ASYNC_ARGV = ["--engine", "async", "--buffer-size", "3", "--staleness-beta", "0.5",
              "--latency", "--compression", "int4", "--packed-wire"]
# the plane kernels the materialized int4 packed compressor launches once
# per leaf a wave (the payload stage of the slow path)
ASYNC_WIRE = ("wire_quantize", "nibble_unpack", "dequantize")


def _buffer_stream(K: int, B: int, waves: int):
    """The flushes and staleness_mean of each wave of a buffer of B under K
    full-participation arrivals a wave, as the engine's arrival loop counts
    them (every client of a wave downloads the wave's opening version)."""
    slots, version, out = [], 0, []
    for _ in range(waves):
        v0, flushes, stale = version, 0, []
        for _ in range(K):
            slots.append(v0)
            if len(slots) == B:
                stale += [version - v for v in slots]
                slots, version, flushes = [], version + 1, flushes + 1
        out.append((float(flushes), sum(stale) / max(len(stale), 1)))
    return out


def phase_paper_async_parity(torch, params_sync: dict):
    """Two waves of rnnt-librispeech through the training entry point on
    the async engine at the sync-parity plane (``--buffer-size 4`` = K, one
    device tier, no jitter), K2 with the fused joint: each wave flushes
    once at staleness 0, so its losses must equal K2_ROUND_LOSSES and its
    server parameters after wave 2 the K2 sync run's (``params_sync``) bit
    for bit; each wave launches exactly the K2 round's kernels. Returns the
    waves' seconds."""
    from repro_torch.core.cohort import LatencyConfig
    from repro_torch.launch import train

    _dispatch("auto")
    task = _paper_task(True)
    cfg, rounds = task.config, 2
    args = train.parse_args(PAPER_ARGV + ["--rounds", str(rounds)] + ASYNC_PARITY_ARGV)
    plan = dataclasses.replace(train.build_plan(args), latency=LatencyConfig(
        spread=0.0, tier_speeds=(1.0,), tier_probs=(1.0,)))
    tag = "[paper async parity B=K]"
    marks = []

    def after_round(line):
        log(f"{tag} {line}")
        marks.append((_counts(), torch.cuda.max_memory_allocated()))

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with _RoundTap(False, "async") as tap:
        state, hist = train.run_federated(task, task.make_corpus(0), plan, rounds,
                                          seed=args.seed, device="cuda", eval_every=0,
                                          eval_examples=0, log=after_round)
    torch.cuda.synchronize()
    want = {k: 0 for k in marks[0][0]}
    want.update(_k2_launches(cfg, args.clients * hist["local_steps"]))
    prev = {k: 0 for k in want}
    for r, (mark, _) in enumerate(marks):
        got = {k: mark[k] - prev[k] for k in want}
        if got != want:
            raise AssertionError(f"{tag} launches in wave {r + 1} {got}, expected {want}")
        prev = mark
    if tuple(hist["loss"]) != K2_ROUND_LOSSES:
        raise AssertionError(f"{tag} losses {hist['loss']} are not K2_ROUND_LOSSES "
                             f"{list(K2_ROUND_LOSSES)} bit for bit")
    bad = [k for k in params_sync if not torch.equal(state.params[k].cpu(), params_sync[k])]
    if bad:
        err = max(float((state.params[k].cpu() - params_sync[k]).abs().max()) for k in bad)
        raise AssertionError(f"{tag} server parameters after wave {rounds} differ from the K2 "
                             f"sync run's in {len(bad)} tensors, by up to {err:.3e}: {bad[:4]}")
    stream = [(m["server_steps"], m["staleness_mean"], m["sim_time_s"]) for m in tap.metrics]
    if stream != [(1.0, 0.0, plan.latency.base_s)] * rounds:
        raise AssertionError(f"{tag} (server steps, staleness_mean, sim_time_s) a wave "
                             f"{stream}, expected one flush at staleness 0 a wave")
    per_s = [e / t for e, t in zip(hist["examples"], hist["round_s"])]
    log(f"{tag} losses {hist['loss']} equal K2_ROUND_LOSSES bit for bit; server parameters "
        f"after wave {rounds} equal the K2 sync run's bit for bit ({len(params_sync)} tensors); "
        f"(server steps, staleness_mean, sim_time_s) a wave {stream}; ms per wave "
        f"{[round(x * 1e3, 1) for x in hist['round_s']]}; client examples per second {per_s}; "
        f"peak memory over the waves {marks[-1][1]} B; launches per wave: "
        + ", ".join(f"{k} {v}" for k, v in want.items() if v))
    return hist["round_s"]


def phase_paper_async(torch):
    """Three waves of rnnt-librispeech on the async engine with a buffer of
    3 at K = 4 (so arrivals carry across waves), the staleness discount
    (beta 0.5), the latency model and an int4 packed uplink, K2 with the
    fused joint: two counted waves and a third under torch.profiler. Each
    wave launches the K2 round's kernels and each of ASYNC_WIRE once per
    leaf; its flushes and staleness_mean are the buffer's arithmetic
    (``_buffer_stream``); its simulated seconds are at most the barrier's
    (the wave's slowest arrival, drawn from the same key), and less in all;
    the uplink per reporting client is exact. Returns {kernel: launches
    over the run}."""
    from repro_torch.core import keys
    from repro_torch.core.cohort import make_latency_fn
    from repro_torch.core.fedavg import _latency_key
    from repro_torch.launch import train

    _dispatch("auto")
    task = _paper_task(True)
    cfg, rounds = task.config, 3
    args = train.parse_args(PAPER_ARGV + ["--rounds", str(rounds)] + ASYNC_ARGV)
    plan = train.build_plan(args)
    K, B = plan.clients_per_round, plan.asynchrony.resolve_buffer(plan.clients_per_round)
    tag = f"[paper async B={B}]"
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with _RoundTap(False, "async") as tap:
        watch = _RunWatch(torch, tag, rounds, tap)
        _, hist = train.run_federated(task, task.make_corpus(0), plan, rounds, seed=args.seed,
                                      device="cuda", eval_every=0, eval_examples=0, log=watch)
    want = {k: 0 for k in watch.marks[0][0]}
    want.update(_k2_launches(cfg, K * hist["local_steps"]), **{k: N_LEAVES for k in ASYNC_WIRE})
    watch.check_launches(want)
    stream = [(m["server_steps"], m["staleness_mean"]) for m in tap.metrics]
    expect = _buffer_stream(K, B, rounds)
    if [f for f, _ in stream] != [f for f, _ in expect] or not all(
            math.isclose(s, e, rel_tol=1e-6) for (_, s), (_, e) in zip(stream, expect)):
        raise AssertionError(f"{tag} (flushes, staleness_mean) a wave {stream}, the buffer's "
                             f"arithmetic gives {expect}")
    latency = make_latency_fn(plan.latency)
    base = keys.PRNGKey(args.seed + 1)
    barrier = [float(latency(_latency_key(base, r), K).max()) for r in range(rounds)]
    sim = [m["sim_time_s"] for m in tap.metrics]
    if any(s > b for s, b in zip(sim, barrier)) or not sum(sim) < sum(barrier):
        raise AssertionError(f"{tag} simulated seconds a wave {sim} against the barrier's "
                             f"{barrier}")
    uplink = COMPRESSED[0][3]  # int4 packed, per reporting client
    if hist["uplink_bytes_client"] != uplink or \
            hist["uplink_bytes_total"] != uplink * K * rounds or \
            [m["participants"] for m in tap.metrics] != [K] * rounds:
        raise AssertionError(f"{tag} uplink {hist['uplink_bytes_client']} B per client, "
                             f"{hist['uplink_bytes_total']} B in all; expected {uplink}")
    if not all(math.isfinite(x) for x in hist["loss"]):
        raise AssertionError(f"{tag} losses are not finite: {hist['loss']}")
    per_s = [e / t for e, t in zip(hist["examples"], hist["round_s"])]
    log(f"{tag} {plan.asynchrony}, {plan.compression}: losses {hist['loss']}; (flushes, "
        f"staleness_mean) a wave {stream}; simulated seconds a wave {sim} (sum {sum(sim)}) "
        f"against the barrier's {barrier} (sum {sum(barrier)}); ms per wave "
        f"{[round(x * 1e3, 1) for x in hist['round_s']]} (wave 3 profiled); client examples "
        f"per second {per_s}; peak memory over waves 1 and 2 {watch.marks[1][1]} B, over "
        f"all {watch.marks[-1][1]} B; uplink {uplink} B per reporting client; launches per "
        f"wave: " + ", ".join(f"{k} {v}" for k, v in want.items() if v))
    _log_profile(tag, _device_times(torch, watch.prof), hist["round_s"][1], hist["round_s"][2],
                 what="wave")
    return watch.marks[-1][0]


@contextlib.contextmanager
def _plain_on_card():
    """The forwards the per-client panel launches (K1's, K2's and K3's)
    take their plain versions, on the card, inside the block: each module's
    forward wrapper, which its entry points (``lstm_gates``,
    ``LSTMScanFn``, ``RNNTJointFn``) call by name, is swapped for the
    plain function of the same contract and put back after."""
    from repro_torch.kernels import lstm_gates as K1
    from repro_torch.kernels import lstm_scan as K2
    from repro_torch.kernels import ref
    from repro_torch.kernels import rnnt_joint as KJ

    swaps = ((K1, "lstm_gates_fwd", ref.lstm_gates_ref), (K2, "lstm_scan_fwd", ref.lstm_scan_ref),
             (KJ, "rnnt_joint_fwd", ref.rnnt_joint_fwd_ref))
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def phase_paper_client_eval(torch):
    """Two K2 rounds of rnnt-librispeech through the training entry point
    with the per-client plane on (``--client-eval 6``, 4 examples each) and
    a checkpoint directory under build/: each round's panel measure timed
    (synchronised) with its exact launches (one forward over the 24
    examples: each K2 layer and K3 once; one greedy decode: the encoder's
    K2 layers once, the predictor's K1 steps), a finite spread with
    p10 <= p90; the last round's panel measured again on the final
    parameters with the plain versions on the card (``_plain_on_card``, no
    launch): each client's WER equal, its loss within SCAN_LOSS_RTOL (K2
    carries h in fp32 as its plain version does; their bf16 ys may differ
    by an ulp); then the checkpointer: each save timed, and
    ``restore_latest`` of the last round timed and held to the run's final
    parameters bit for bit, with the files' bytes."""
    import os
    import shutil

    import numpy as np

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.clienteval import ClientEvalPlane
    from repro_torch.core.metrics import SPREAD_KEYS
    from repro_torch.launch import train

    _dispatch("auto")
    task = _paper_task(True)
    cfg, rounds = task.config, 2
    corpus = task.make_corpus(0)
    args = train.parse_args(PAPER_ARGV + ["--rounds", str(rounds), "--client-eval", "6"])
    tag = "[paper client eval]"
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    measures, saves = [], []

    planes = []

    def timed(fn, record, counted: bool):
        def call(*a, **kw):
            if counted:
                planes.append(a[0])
            torch.cuda.synchronize()
            before, t0 = _counts(), time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            after = _counts()
            record.append((time.perf_counter() - t0,
                           {k: after[k] - before[k] for k in after} if counted else None))
            return out
        return call

    measure, save = ClientEvalPlane.measure, Checkpointer.save
    ClientEvalPlane.measure = timed(measure, measures, True)
    Checkpointer.save = timed(save, saves, False)
    try:
        state, hist = train.run_federated(
            task, corpus, train.build_plan(args), rounds, seed=args.seed, device="cuda",
            eval_every=0, eval_examples=0, client_eval=args.client_eval,
            client_eval_examples=args.client_eval_examples, ckpt_dir=str(ckdir),
            log=lambda line: log(f"{tag} {line}"))
    finally:
        ClientEvalPlane.measure, Checkpointer.save = measure, save
    t_enc = corpus.t_max // cfg.time_stride
    want = {k: 0 for k in measures[0][1]}
    want.update(lstm_scan_fwd=2 * cfg.enc_layers + cfg.pred_layers,
                lstm_gates_fwd=cfg.pred_layers * (1 + t_enc * 4),
                **{k: 1 for k in JOINT_KERNELS if k.startswith("rnnt_joint_fwd")})
    for r, (_, got) in enumerate(measures):
        if got != want:
            raise AssertionError(f"{tag} the panel's launches in round {r + 1} {got}, "
                                 f"expected {want}")
    spread = {k: hist[k] for k in SPREAD_KEYS}
    curves = hist["client_eval"]
    if len(measures) != rounds or spread["clients_tracked"] != args.client_eval or \
            not all(math.isfinite(v) for v in spread.values()) or \
            not spread["client_loss_p10"] <= spread["client_loss_p90"] or \
            not spread["client_quality_p10"] <= spread["client_quality_p90"] or \
            [len(c) for c in curves["client_loss"]] != [args.client_eval] * rounds:
        raise AssertionError(f"{tag} spread {spread}, curves {curves}")
    log(f"{tag} panel {curves['client_ids']} x {args.client_eval_examples} examples: ms a "
        f"round {[round(t * 1e3, 1) for t, _ in measures]} (synchronised); launches a round "
        + ", ".join(f"{k} {v}" for k, v in want.items() if v)
        + f"; spread {spread}; training ms per round "
        f"{[round(x * 1e3, 1) for x in hist['round_s']]}")

    plane, last = planes[-1], planes[-1].history[-1]
    before = _counts()
    with _plain_on_card():
        plain_loss = plane.task.client_loss(state.params, plane.batch)
        plain_quality = plane.task.client_quality(state.params, plane.batch)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in _counts().items() if v != before[k]}
    rel = np.abs(last["client_loss"] - plain_loss) / np.abs(plain_loss)
    if launched or not np.array_equal(last["client_quality"], plain_quality) or \
            not np.all(rel <= SCAN_LOSS_RTOL):
        raise AssertionError(
            f"{tag} the last round's panel on the kernels (loss {last['client_loss']}, "
            f"WER {last['client_quality']}) against the plain versions on the card (loss "
            f"{plain_loss}, WER {plain_quality}; relative loss gaps {rel}, tol "
            f"{SCAN_LOSS_RTOL}; launches in the plain run {launched})")
    log(f"{tag} the last round's panel against the plain versions on the card: WER equal "
        f"{plain_quality.tolist()}, loss {last['client_loss'].tolist()} vs "
        f"{plain_loss.tolist()}, largest relative gap {float(rel.max()):.3e} "
        f"(tol {SCAN_LOSS_RTOL})")

    ckpt = Checkpointer(str(ckdir))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, extra = ckpt.restore_latest(state.params)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    bad = [k for k in state.params if restored[k].device != state.params[k].device
           or not torch.equal(restored[k], state.params[k])]
    if bad or ckpt.latest_round() != rounds or extra["round"] != rounds:
        raise AssertionError(f"{tag} the restored checkpoint (round {ckpt.latest_round()}) "
                             f"differs from the final parameters in {bad[:4]}")
    base = ckdir / f"ckpt_{rounds}"
    nbytes = [os.path.getsize(f"{base}.{ext}") for ext in ("npz", "json")]
    log(f"[checkpoint] {len(saves)} saves of {hist['n_params']} fp32 parameters "
        f"({4 * hist['n_params']} B): ms {[round(t * 1e3, 1) for t, _ in saves]} (from the "
        f"card, synchronised); restore_latest {t_restore * 1e3:.1f} ms (to the card); files "
        f"{nbytes[0]} B npz, {nbytes[1]} B json; the restored parameters equal the final "
        f"ones bit for bit; extra {extra}")
    shutil.rmtree(ckdir)


def phase_tiny_sweeps(torch):
    """The sweep runner's smoke grids on the card at the tiny task, each
    with its ``--check``: async_vs_sync (two pairs, 10 rounds, K=8, B=5) and
    client_eval (three rungs, 6 rounds, a panel of 6). Returns {grid: wall
    seconds}."""
    from repro_torch.launch import sweeps

    _dispatch("auto")
    walls = {}
    for grid in ("async_vs_sync", "client_eval"):
        tag = f"[sweeps {grid}]"
        t0 = time.perf_counter()
        frontier = sweeps.run_grid(grid, smoke=True, check=True, device="cuda",
                                   out=str(ROOT / "build" / f"sweep_{grid}_torch.json"),
                                   log=lambda line, tag=tag: log(f"{tag} {line}"))
        walls[grid] = time.perf_counter() - t0
        log(f"{tag} --check holds on the card: {frontier['n_points']} points in "
            f"{walls[grid]:.1f} s (the rows' wall_s "
            f"{[round(r['wall_s'], 2) for r in frontier['points']]})")
    return walls


def phase_paper_sweep_pair(torch):
    """A paper-width async_vs_sync pair through ``SweepRunner`` (K=4, B=3,
    3 rounds, the latency model on, K2 with the fused joint, 4 evaluation
    examples a split; the async arm's server lr scaled by B/K as the grid
    scales it), held to ``check_async_vs_sync``: equal CFMQ and wire bytes,
    fewer simulated seconds for the async arm."""
    from repro_torch.core.plan import AsyncConfig
    from repro_torch.launch import sweeps, train

    _dispatch("auto")
    task = _paper_task(True)
    args = train.parse_args(PAPER_ARGV + ["--rounds", "3", "--latency"])
    sync, B = train.build_plan(args), 3
    asyn = dataclasses.replace(sync, engine="async", server_lr=sync.server_lr * B / args.clients,
                               asynchrony=AsyncConfig(buffer_size=B, staleness_beta=0.5))
    points = [sweeps.SweepPoint(id=f"{name}_paper", plan=plan, rounds=3, seed=args.seed,
                                meta={"pair": "paper", "engine": plan.engine})
              for name, plan in (("sync", sync), ("async", asyn))]
    tag = "[paper sweep pair]"
    runner = sweeps.SweepRunner(task=task, corpus=task.make_corpus(0), eval_examples=4,
                                device="cuda")
    t0 = time.perf_counter()
    rows = runner.run(points, log=lambda line: log(f"{tag} {line}"))
    wall = time.perf_counter() - t0
    sweeps.check_async_vs_sync({"points": rows}, log=lambda line: log(f"{tag} {line}"))
    log(f"{tag} check_async_vs_sync holds in {wall:.1f} s: "
        + "; ".join(f"{r['id']} sim_time_s {r['sim_time_s']}, server steps "
                    f"{r['server_steps_total']}, final loss {r['final_loss']}, cfmq_bytes "
                    f"{r['cfmq_bytes']}, wire bytes {r['wire_bytes_total']}, wall "
                    f"{r['wall_s']:.2f} s" for r in rows))


def _python_spans(prof) -> list:
    """(file, function, start us, end us, thread) of each Python call that
    torch.profiler's stack tracing recorded in the port's files and in
    torch.autograd: the ``python_function`` events of its trace."""
    trace = ROOT / "build" / "host_parts_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    with open(trace) as f:
        events = json.load(f)
    trace.unlink()
    spans = []
    for e in events["traceEvents"] if isinstance(events, dict) else events:
        if e.get("cat") != "python_function" or "dur" not in e:
            continue
        where, sep, fn = e["name"].partition("): ")
        path = where.rsplit("(", 1)[0]
        if sep and ("repro_torch/" in path or path.endswith("torch/autograd/__init__.py")):
            spans.append((path, fn, float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e.get("tid")))
    return spans


# the host parts of a K2 round: (part, the port's file, function), each
# summed over its calls; the local optimizer is the optimizer calls inside
# the clients' updates, the server stage the round body's time outside them
HOST_PARTS = (
    ("sampler (pipeline.next_round)", "repro_torch/data/pipeline.py", "next_round"),
    ("copy to the card (train._to_device)", "repro_torch/launch/train.py", "_to_device"),
    ("clients' loss forward (task.loss_fn)", "repro_torch/core/task.py", "loss_fn"),
    ("clients' torch.autograd.grad", "torch/autograd/__init__.py", "grad"),
    ("clients' fvn.perturb", "repro_torch/core/fvn.py", "perturb"),
)


def phase_host_parts(torch, round_s: float):
    """One K2 round (the K2 run's configuration) under torch.profiler with
    the host's Python calls traced (``with_stack=True``): the host seconds
    under each of the port's functions (HOST_PARTS, the clients' local
    optimizer and the server stage), beside the round's wall time and busy
    share. Stack tracing slows the host: the profiled round is printed
    beside the unprofiled ``round_s``. Measures only; the package is
    unchanged."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    _dispatch("auto")
    task = _paper_task(True)
    args = train.parse_args(PAPER_ARGV + ["--rounds", "1"])
    corpus = task.make_corpus(0)
    tag = "[host parts auto use_kernel=True]"
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True) as prof:
        _, hist = train.run_federated(task, corpus, train.build_plan(args), 1, seed=args.seed,
                                      device="cuda", eval_every=0, eval_examples=0,
                                      log=lambda line: None)
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    spans = _python_spans(prof)
    device_s = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    parse_s = time.perf_counter() - t1

    def total(path: str, fn: str, inside=None) -> float:
        out = 0.0
        for p, f, a, b, th in spans:
            if f == fn and p.endswith(path) and (
                    inside is None or any(th == t and s <= a and b <= e for s, e, t in inside)):
                out += b - a
        return out / 1e6

    clients = [(a, b, th) for p, f, a, b, th in spans
               if f == "_client_update" and p.endswith("repro_torch/core/fedavg.py")]
    client_s = sum(b - a for a, b, _ in clients) / 1e6
    body_s = total("repro_torch/core/fedavg.py", "_fedavg_round_body")
    parts = {part: total(path, fn) for part, path, fn in HOST_PARTS}
    parts["clients' local optimizer (sgd update, apply_updates)"] = sum(
        total("repro_torch/optim/optimizers.py", fn, clients) for fn in ("update", "apply_updates"))
    inner = sum(v for k, v in parts.items() if k.startswith("clients'"))
    parts["clients' rest of _client_update (the loop, the delta)"] = client_s - inner
    parts["server stage (the round body outside the clients: the mean, Adam, the metrics' "
          "syncs)"] = body_s - client_s
    wall = hist["round_s"][0]
    if not clients or body_s <= 0:
        raise AssertionError(f"{tag} the profiler traced no client update ({len(spans)} Python "
                             "spans of the port)")
    log(f"{tag} one round ({len(clients)} clients' updates; {len(spans)} Python spans of the "
        f"port, read in {parse_s:.1f} s): round wall time {wall * 1e3:.1f} ms under the profiler "
        f"(unprofiled {round_s * 1e3:.1f} ms), the run {run_s * 1e3:.1f} ms; device kernel time "
        f"{device_s * 1e3:.1f} ms, busy share {device_s / round_s:.3f} of the unprofiled round, "
        f"{device_s / wall:.3f} of the profiled one")
    for part, sec in parts.items():
        log(f"{tag}   {sec * 1e3:9.2f} ms  {sec / wall:6.3f} of the profiled round  {part}")


def phase_profile(torch, round_s: float, use_kernel: bool, mode: str, enc_layers=None,
                  flags=()):
    """One more paper-width round on its own under torch.profiler, with
    no final evaluation: the device's kernel time against the wall time
    of the counted run's last round (the busy share), and the kernels
    that fill it. ``flags`` are further CLI flags (the fedsgd engine)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    _dispatch(mode)
    task = _paper_task(use_kernel, enc_layers)
    args = train.parse_args(PAPER_ARGV + ["--rounds", "1", *flags])
    tag = (f"[profile {mode} use_kernel={use_kernel} enc_layers={task.config.enc_layers}"
           + "".join(f" {f}" for f in flags) + "]")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only
        _, hist = train.run_federated(task, task.make_corpus(0), train.build_plan(args), 1,
                                      seed=args.seed, device="cuda", eval_every=0,
                                      eval_examples=0, log=lambda line: None)
        torch.cuda.synchronize()
    _log_profile(tag, _device_times(torch, prof), round_s, hist["round_s"][0])


def phase_autotune(torch):
    """The tuner's entry point on the card at the paper's width (B=4,
    H=1152) over the JAX package's sequence lengths, not persisted: the
    length from which K2 beats the time loop, forward plus backward."""
    from repro_torch.profile import tuner

    t0 = time.perf_counter()
    chosen = tuner.autotune_lstm_scan(tuner.registry(), batch=4, hidden=1152, reps=3,
                                      persist=False, device="cuda", log=log)
    tuner.registry().clear_override("lstm.scan_min_seq")
    log(f"[tuner] measured lstm.scan_min_seq {chosen} at B=4 H=1152 in "
        f"{time.perf_counter() - t0:.1f} s (not kept: the runs above use the default)")


# K10 and K11 against their plain versions on the card, (atol, rtol): fp32
# sums of D products and of Sk terms in another order (tests/test_kernels.py:22);
# in bf16 both compute in fp32 from the same inputs, so two outputs differ by
# their final rounding, at most one bf16 ulp (2**-7 relative at a power of
# two, 2**-9 = 1.95e-3 for |x| in [0.25, 0.5), the largest error read on the
# card at these shapes): rtol 8e-3 covers one ulp at any |x|, atol the
# outputs near 0
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (4e-3, 8e-3)}

# K10's shapes: Whisper-base's encoder self-attention (B=4 utterances of
# 1,500 frames, 8 heads of 64), the decoder's cross-attention at a 4-token
# prompt and at 448 target positions, its causal self-attention over the
# 4-token prompt (prefill), over 64 tokens (phase 5's decode_train) and at 448, a
# ragged GQA shape with a window, softcap, query offset and scale (D=96,
# Dv=80: the kernel's 128-wide variant), and a shape whose rows 19-39 have
# no valid key (F5). (name, B, Sq, Sk, H, Kv, D, Dv, causal, window,
# softcap, q_offset, scale)
K10_SHAPES = (
    ("encoder", 4, 1500, 1500, 8, 8, 64, 64, False, None, 0.0, 0, None),
    ("cross prompt", 4, 4, 1500, 8, 8, 64, 64, False, None, 0.0, 0, None),
    ("cross U=448", 4, 448, 1500, 8, 8, 64, 64, False, None, 0.0, 0, None),
    ("causal self prompt", 4, 4, 4, 8, 8, 64, 64, True, None, 0.0, 0, None),
    ("causal self U=64", 4, 64, 64, 8, 8, 64, 64, True, None, 0.0, 0, None),
    ("causal self U=448", 4, 448, 448, 8, 8, 64, 64, True, None, 0.0, 0, None),
    ("gqa window softcap", 2, 333, 517, 8, 2, 96, 80, True, 100, 30.0, 184, 0.1),
    ("no valid key", 1, 40, 16, 2, 1, 16, 16, True, 4, 0.0, 0, None),
    # qwen3-8b's head layout (32 query heads on 8 kv heads of 128, G = 4),
    # causal over 128 tokens: the next attention model's training shape
    ("qwen3-8b heads", 4, 128, 128, 32, 8, 128, 128, True, None, 0.0, 0, None),
    # zamba2-7b's shared block (32 heads on 32 kv heads of 112), causal over
    # 128 tokens: the first width that is not 8, 64 or 128 (the tensor-core
    # forward pads it to 128 columns, its backward takes <2, 2>)
    ("zamba2-7b heads", 4, 128, 128, 32, 32, 112, 112, True, None, 0.0, 0, None),
    # deepseek-v2-lite-16b's multi-head latent attention (16 heads, q.k width
    # 128 + 64 = 192, v width 128, MLA's scale 192 ** -0.5), causal over 128
    # tokens: the tensor-core forward's ND = 3, its backward's two-warpgroup
    # dK/dV; and the contract's cases at those widths (a window, a softcap,
    # H = 2 Kv, ragged Sq = 100 against Sk = 130, a query offset)
    ("deepseek-v2-lite heads", 4, 128, 128, 16, 16, 192, 128, True, None, 0.0, 0, 192 ** -0.5),
    ("d192 gqa window softcap", 2, 100, 130, 4, 2, 192, 128, True, 40, 30.0, 30, None),
    # llava-next-mistral-7b's layout with Mistral's window acting: 576 image
    # tokens + 4,096 text positions, 32 heads on 8 kv heads of 128, causal,
    # window 4,096 (the rows past 4,096 lose their first keys: the forward
    # skips each tile wholly below a row block's window, masks the rest);
    # SDPA's yardstick takes the same window as an explicit boolean mask
    ("llava-next window", 1, 4672, 4672, 32, 8, 128, 128, True, 4096, 0.0, 0, None),
    # gemma3-4b's heads of 256 (8 query heads on 4 kv heads, D = Dv = 256) at
    # train_4k's 4,096 positions: a local layer (window 1,024) and the global
    # one; the tensor-core forward's two warpgroups (Dv > 128) and the
    # backward's column halves (ND = NV = 4), the CUDA-core routes' tiles of
    # 256; and a ragged row at those widths with a window and a softcap
    ("gemma3 local", 1, 4096, 4096, 8, 4, 256, 256, True, 1024, 0.0, 0, None),
    ("gemma3 global", 1, 4096, 4096, 8, 4, 256, 256, True, None, 0.0, 0, None),
    ("d256 ragged window softcap", 1, 1000, 1000, 8, 4, 256, 256, True, 300, 30.0, 0, None),
)
# K11's shapes: the self cache (448 slots) at three positions, the cross
# cache (1,500 slots), a GQA ring buffer with a window and softcap (G=8,
# D=128), and qwen3-8b's head layout over a 128-slot cache (G=4, D=128).
# (name, B, S, H, Kv, D, pos, window, ring, softcap)
K11_SHAPES = (
    ("self pos 3", 4, 448, 8, 8, 64, 3, None, False, 0.0),
    ("self pos 200", 4, 448, 8, 8, 64, 200, None, False, 0.0),
    ("self pos 447", 4, 448, 8, 8, 64, 447, None, False, 0.0),
    ("cross", 4, 1500, 8, 8, 64, 1499, None, False, 0.0),
    ("gqa ring window", 2, 256, 16, 2, 128, 1000, 200, True, 20.0),
    ("qwen3-8b heads pos 127", 4, 128, 32, 8, 128, 127, None, False, 0.0),
    # zamba2-7b's shared block over its serve's 160-slot cache (G=1, D=112)
    ("zamba2-7b heads pos 159", 4, 160, 32, 32, 112, 159, None, False, 0.0),
    # llava-next-mistral-7b's serve: 576 image + 128 prompt + 32 steps = 736
    # slots, the last step at pos 735 (G=4, D=128), the window 4,096 passed
    # (it masks nothing here, so SDPA without a mask is its yardstick)
    ("llava-next serve pos 735", 4, 736, 32, 8, 128, 735, 4096, False, 0.0),
    # gemma3-4b's serve: 1,152 prompt + 32 steps = 1,184 slots, the last step
    # at pos 1,183 (G = 2, D = 256), a local layer's window of 1,024 acting
    # (SDPA over the window's slots is its yardstick) and the global layer's
    ("gemma3 serve pos 1183", 4, 1184, 8, 4, 256, 1183, 1024, False, 0.0),
    ("gemma3 serve global pos 1183", 4, 1184, 8, 4, 256, 1183, None, False, 0.0),
)


def _sdpa_backends(torch, fn) -> str:
    """The SDPA backends that take the call ``fn``, each tried alone (the
    yardstick's default dispatch takes the first of its own order); "none"
    where every one refuses."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    took = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                fn()
        except RuntimeError:  # this backend refuses the shape; a yardstick, not the port
            continue
        took.append(backend.name.lower())
    return ", ".join(took) or "none"


def _sdpa(torch, fn, what: str):
    """A yardstick call, None where this torch refuses it."""
    try:
        fn()
    except (RuntimeError, TypeError) as e:  # a measurement, not the port's path
        log(f"[attention] {what}: scaled_dot_product_attention refused ({e}); not timed")
        return None
    return fn


def _attn_times(torch, kernel, plain, lib, n: int) -> dict:
    t = {"kernel": (cuda_ms(torch, kernel, n), graph_ms(torch, kernel, max(2, n // 2))),
         "plain": (cuda_ms(torch, plain, max(2, n // 4)),
                   _maybe_graph_ms(torch, plain, 2, "plain attention"))}
    t["library"] = (None, None) if lib is None else \
        (cuda_ms(torch, lib, n), _maybe_graph_ms(torch, lib, max(2, n // 2), "sdpa"))
    return t


# K10's tensor-core route against the plain version's bf16 result at the
# encoder: at most this share of outputs may differ (a one-term bf16 p
# would change about 0.4 of them, tests/test_torch_attention.py)
K10_BF16_DIFF_MAX = 0.02


def _k10_grad_path(torch, KA) -> None:
    """On the card a call in grad mode with an input that requires grad
    runs through K10Function: one forward launch (with the log-sum-exp),
    then one backward call when autograd asks, whose gradients equal a
    direct call of the backward on the same inputs bit for bit; the same
    call under torch.no_grad() launches the forward alone."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = (torch.randn((2, 48, 8, 64), generator=gen, device="cuda").to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    do = torch.randn((2, 48, 8, 64), generator=gen, device="cuda").to(torch.bfloat16)
    before = (KA.FWD_LAUNCHES, KA.BWD_LAUNCHES)
    out = KA.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    moved = (KA.FWD_LAUNCHES - before[0], KA.BWD_LAUNCHES - before[1])
    o, lse = KA.flash_attention_fwd_lse(q.detach(), k.detach(), v.detach(), causal=True)
    want = KA.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse, do, causal=True)
    if moved != (1, 1) or not torch.equal(out.detach(), o) or \
            not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"flash_attention under autograd: launches (fwd, bwd) {moved}, "
                             "expected (1, 1), or its output or gradients differ from direct "
                             "calls of the forward and the backward")
    before = (KA.FWD_LAUNCHES, KA.BWD_LAUNCHES)
    with torch.no_grad():
        out = KA.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    if (KA.FWD_LAUNCHES - before[0], KA.BWD_LAUNCHES - before[1]) != (1, 0) or \
            out.requires_grad:
        raise AssertionError("flash_attention under no_grad did not launch its forward alone")
    log("[kernels] flash_attention: in grad mode with inputs that require grad, one forward "
        "launch (with the log-sum-exp) and one backward call, the gradients bitwise those of "
        "direct calls; under torch.no_grad() the forward alone")


# K10's backward at the whisper-base training shapes (b=4 utterances of 384
# frames, 48 target tokens, 8 heads of 64: the encoder's self-attention, the
# decoder's causal self-attention and its cross-attention) and K10_SHAPES'
# ragged GQA row with a window, softcap and query offset and its rows with
# no valid key. Each gradient is held relative to its largest entry: fp32 at
# sums in another order, bf16 at one bf16 ulp of the largest entry (the
# kernel and the plain version round the same fp32 sums to bf16).
K10_BWD_SHAPES = (
    ("train encoder", 4, 384, 384, 8, 8, 64, 64, False, None, 0.0, 0, None),
    ("train causal self", 4, 48, 48, 8, 8, 64, 64, True, None, 0.0, 0, None),
    ("train cross", 4, 48, 384, 8, 8, 64, 64, False, None, 0.0, 0, None),
) + tuple(sh for sh in K10_SHAPES if sh[0] in ("gqa window softcap", "no valid key",
                                               "qwen3-8b heads", "zamba2-7b heads",
                                               "deepseek-v2-lite heads",
                                               "d192 gqa window softcap",
                                               "llava-next window", "gemma3 local",
                                               "gemma3 global",
                                               "d256 ragged window softcap"))
ATTN_BWD_TOL = {"float32": 2e-5, "bfloat16": 8e-3}
# the forward's log-sum-exp against the plain version's: fp32 sums in
# another order (and the tensor-core route's ex2.approx), rows of O(10)
ATTN_LSE_ATOL = 1e-4


def _window_only(window, cap, off: int, Sq: int, Sk: int) -> bool:
    """A causal self-attention whose only other mask is a window that acts
    (some row loses keys to it): SDPA's yardstick then takes the mask as an
    explicit boolean ``attn_mask``."""
    return bool(window) and window < Sk and not cap and off == 0 and Sq == Sk


def _taken(window, D: int, Dv: int) -> str:
    """What the SDPA backends named beside a row were asked to take."""
    return "the window mask" if window else ("D != Dv" if D != Dv else f"a head width of {D}")


def _sdpa_kw(H: int, Kv: int) -> dict:
    """SDPA's grouped-query option where the heads are grouped (a keyword
    an older torch lacks: ``_sdpa`` then reports the yardstick as refused)."""
    return {} if H == Kv else {"enable_gqa": True}


def _old_bwd(torch, KA, q, k, v, o, lse, do, kw):
    """K10's backward on the CUDA-core design (csrc/attention_bwd.cu)
    through its C entry, whatever the route rule picks: the design the
    tensor-core route replaced for bf16, timed beside it. Counts no
    launch."""
    from repro_torch.kernels import build

    B, Sq, H, D = q.shape
    Sk, Kv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    di = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    scale = D ** -0.5 if kw["scale"] is None else float(kw["scale"])
    build.check_launch(KA._bwd_lib().flash_attention_bwd(
        KA.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(),
        B, Sq, Sk, H, Kv, D, Dv, scale, int(bool(kw["causal"])), int(kw["window"] or 0),
        float(kw["logit_softcap"]), int(kw["q_offset"]), torch.cuda.current_stream().cuda_stream),
        "flash_attention_bwd")
    return dq, dk, dv


def _launch_split(torch, fn, calls: int = 5) -> dict:
    """{kernel: device microseconds a call} of ``calls`` calls of ``fn``
    under torch.profiler (device events only), by the kernel's function
    name; {} where the profiler records no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split: dict = {}
    for name, (t, _) in _device_times(torch, prof).items():
        m = re.search(r"(fa_bwd_\w+)", name)
        key = m.group(1) if m else name[:40]
        split[key] = split.get(key, 0.0) + t / calls
    return split


def phase_attention_bwd(torch):
    """K10's backward against its plain version (ref.flash_attention_bwd_ref)
    at K10_BWD_SHAPES in bf16 and fp32: the forward's o bitwise the same
    with and without the log-sum-exp, that log-sum-exp against the plain
    version's (+inf exactly on the rows with no valid key, whose dq is 0;
    keys no row sees get dk and dv 0), every bf16 call on the tensor-core
    route (csrc/attention_bwd_wgmma.cu) and every fp32 one on the CUDA-core
    route (csrc/attention_bwd.cu) by bwd_route, dq, dk and dv within
    ATTN_BWD_TOL with the share of bf16 elements that differ from the
    plain version's, a second call bitwise the first; at each bf16 shape
    also the CUDA-core design through its C entry (held to the same
    tolerance). Each is timed eager and from a CUDA graph beside the plain
    version's, SDPA's backward (a yardstick the port never calls) and the
    bound, with the device time of each of its three launches. Returns
    {kernel: row}: each route at the training encoder shape (bf16 for the
    tensor cores, fp32 for the CUDA cores)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as KA
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(26)
    rows = {}
    for name, B, Sq, Sk, H, Kv, D, Dv, causal, window, cap, off, scale in K10_BWD_SHAPES:
        for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(dtype) for sh in
                       ((B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, Dv)))
            do = torch.randn((B, Sq, H, Dv), generator=gen, device="cuda").to(dtype)
            kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off, scale=scale)
            bf16 = dtype == torch.bfloat16
            want_route = "wgmma" if bf16 else "simt"
            tag = f"flash_attention_bwd {name} {dname}"
            o_alone = KA.flash_attention(q, k, v, **kw)
            o, lse = KA.flash_attention_fwd_lse(q, k, v, **kw)
            if not torch.equal(o, o_alone):
                raise AssertionError(f"{tag}: the forward's o moved with the log-sum-exp write")
            _, lse_ref = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
            mask = ref.attention_mask(Sq, Sk, causal, window, off, "cpu")
            dead = (~mask.any(dim=1)).cuda()
            dead_keys = (~mask.any(dim=0)).cuda()
            live = ~torch.isinf(lse_ref)
            lse_err = float((lse[live] - lse_ref[live]).abs().max())
            if not torch.equal(torch.isinf(lse), ~live) or bool(live[:, :, dead].any()) or \
                    lse_err > ATTN_LSE_ATOL:
                raise AssertionError(f"{tag}: log-sum-exp off by {lse_err:.2e} (atol "
                                     f"{ATTN_LSE_ATOL}) or +inf on other rows than the dead")
            before = (KA.BWD_WGMMA_LAUNCHES, KA.BWD_SIMT_LAUNCHES)
            got = KA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            moved = (KA.BWD_WGMMA_LAUNCHES - before[0], KA.BWD_SIMT_LAUNCHES - before[1])
            took = {(1, 0): "wgmma", (0, 1): "simt"}.get(moved, f"launch counts moved {moved}")
            if took != want_route or KA.bwd_route(q, k, v, o, do) != want_route:
                raise AssertionError(f"{tag}: took the {took} route, expected {want_route}")
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
            designs = {took: got}
            if bf16:  # the CUDA-core design at the same inputs, through its C entry
                designs["simt design"] = _old_bwd(torch, KA, q, k, v, o, lse, do, kw)
                torch.cuda.synchronize()
            errs, differ = {}, {}
            for design, grads in designs.items():
                errs[design] = [_rel(torch, g, w) for g, w in zip(grads, want)]
                differ[design] = [float((g != w).float().mean()) for g, w in zip(grads, want)]
                if any(g.dtype != dtype or g.shape != w.shape for g, w in zip(grads, want)) or \
                        max(errs[design]) > ATTN_BWD_TOL[dname]:
                    raise AssertionError(f"{tag} ({design}): dq, dk, dv relative errors "
                                         f"{errs[design]} (tol {ATTN_BWD_TOL[dname]}) or the "
                                         "shape/dtype contract broke")
                if dead.any() and float(grads[0][:, dead].float().abs().max()) != 0.0:
                    raise AssertionError(f"{tag} ({design}): rows with no valid key have a "
                                         "nonzero dq")
                if dead_keys.any() and max(float(g[:, dead_keys].float().abs().max())
                                           for g in grads[1:]) != 0.0:
                    raise AssertionError(f"{tag} ({design}): keys no row sees have a nonzero "
                                         "dk or dv")
            again = KA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError(f"{tag}: a second call gave other bits")
            n_valid = int(mask.sum()) * B * H
            es = q.element_size()
            nbytes = (2 * (q.numel() + k.numel() + v.numel()) + 2 * B * Sq * H * Dv) * es \
                + 4 * B * H * Sq  # q, k, v, o, do in; dq, dk, dv out; the lse
            # S and dP recomputed, dV, dK and dQ: five products over the valid pairs
            flops = 2 * n_valid * (3 * D + 2 * Dv)
            bound_ms, bound_by = _bound(nbytes, 0 if bf16 else flops, flops if bf16 else 0,
                                        n_valid)
            lib, backends = None, None
            if not window and not cap and off == 0 and (not causal or Sq == Sk):
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
                fwd = _sdpa(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale, **_sdpa_kw(H, Kv)), tag)
                if fwd is not None and (D != Dv or D > 128):
                    backends = _sdpa_backends(torch, lambda: torch.autograd.grad(
                        fwd(), (qt, kt, vt), do.transpose(1, 2)))
                if fwd is not None:
                    out_t, do_t = fwd(), do.transpose(1, 2)
                    lib = _sdpa(torch, lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                                                   retain_graph=True), tag)
            elif _window_only(window, cap, off, Sq, Sk):
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
                allowed = mask.cuda()
                fwd = _sdpa(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=allowed, scale=scale, **_sdpa_kw(H, Kv)), tag)
                if fwd is not None:
                    backends = _sdpa_backends(torch, lambda: torch.autograd.grad(
                        fwd(), (qt, kt, vt), do.transpose(1, 2)))
                    out_t, do_t = fwd(), do.transpose(1, 2)
                    lib = _sdpa(torch, lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                                                   retain_graph=True), tag)
            n = 10 if Sq * Sk > 100_000 else 50
            call = lambda: KA.flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
            t = _attn_times(torch, call,
                            lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
                            lib, n)
            split = {took: _launch_split(torch, call)}
            if bf16:
                old = lambda: _old_bwd(torch, KA, q, k, v, o, lse, do, kw)  # noqa: E731
                t["simt design"] = (cuda_ms(torch, old, n), graph_ms(torch, old, max(2, n // 2)))
                split["simt design"] = _launch_split(torch, old)
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            log(f"[attention] {tag} (B={B} Sq={Sq} Sk={Sk} H={H} Kv={Kv} D={D} Dv={Dv}): "
                f"o bitwise unchanged by the lse write, lse max|err| {lse_err:.2e}, {took} "
                f"route; dq/dk/dv relative errors "
                + "; ".join(f"{d} {', '.join(f'{e:.2e}' for e in es_)}"
                            for d, es_ in errs.items())
                + (" (share of bf16 elements that differ from the plain version's: "
                   + "; ".join(f"{d} {', '.join(f'{x:.4f}' for x in df)}"
                               for d, df in differ.items()) + ")" if bf16 else "")
                + (f", {int(dead.sum())} rows with no valid key: lse +inf, dq 0"
                   if dead.any() else "")
                + "; bitwise repeatable; us per call eager/graph: "
                + ", ".join(f"{w} {_us(e)}/{_us(g)}" for w, (e, g) in t.items())
                + f"; bound {bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B, {flops} flop, "
                  f"{n_valid} exp); device us by launch: "
                + "; ".join(f"{d} " + ", ".join(f"{k_} {v_:.2f}" for k_, v_ in sp.items())
                            for d, sp in split.items())
                + (f"; SDPA backends that take {_taken(window, D, Dv)}, forward and "
                   f"backward: {backends}" if backends else ""))
            if name in ("train encoder", "gemma3 global"):
                rows[f"flash_attention_bwd_{took}" + ("_256" if D == 256 else "")] = {
                    "max_abs_err": err, "ms": t["kernel"][0], "plain_ms": t["plain"][0],
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t["library"][0]}
    return rows


def phase_attention_kernels(torch):
    """K10 and K11 against their plain versions at K10_SHAPES and
    K11_SHAPES (and K11 at the split edges of the self cache), in bf16 and
    fp32, with their times (eager and from a CUDA graph) beside the bound,
    the plain version's and ``scaled_dot_product_attention``'s on the same
    inputs (a yardstick the port never calls); every bf16 K10 shape on the
    tensor-core route, every fp32 one on the CUDA-core route; K11 replayed
    from one CUDA graph while pos advances on the device. Returns {kernel:
    row}: K10's routes at the encoder (bf16 and fp32), K11 at the cross
    cache in bf16."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KA
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(16)
    _k10_grad_path(torch, KA)
    rows = {}
    for name, B, Sq, Sk, H, Kv, D, Dv, causal, window, cap, off, scale in K10_SHAPES:
        for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype) for s in
                       ((B, Sq, H, D), (B, Sk, Kv, D), (B, Sk, Kv, Dv)))
            kw = dict(causal=causal, window=window, logit_softcap=cap, q_offset=off, scale=scale)
            bf16 = dtype == torch.bfloat16
            want_route = "wgmma" if bf16 else "simt"
            tag = f"flash_attention {name} {dname}"
            before = (KA.WGMMA_LAUNCHES, KA.SIMT_LAUNCHES)
            got = KA.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            moved = (KA.WGMMA_LAUNCHES - before[0], KA.SIMT_LAUNCHES - before[1])
            took = {(1, 0): "wgmma", (0, 1): "simt"}.get(moved, f"launch counts moved {moved}")
            if took != want_route or KA.route(q, k, v) != want_route:
                raise AssertionError(f"{tag}: took the {took} route, expected {want_route}")
            want = ref.flash_attention_ref(q, k, v, **kw)
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"{tag}: the kernel broke the shape or dtype contract")
            atol, rtol = ATTN_TOL[dname]
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{tag}: {m}")
            differ = float((got != want).float().mean())
            if bf16 and name == "encoder" and differ > K10_BF16_DIFF_MAX:
                raise AssertionError(f"{tag}: {differ:.4f} of the outputs differ from the plain "
                                     f"version's bf16 result (at most {K10_BF16_DIFF_MAX})")
            if not torch.equal(KA.flash_attention(q, k, v, **kw), got):
                raise AssertionError(f"{tag}: a second launch gave other bits")
            mask = ref.attention_mask(Sq, Sk, causal, window, off, "cpu")
            dead = (~mask.any(dim=1)).cuda()
            if dead.any() and float(got[:, dead].float().abs().max()) != 0.0:
                raise AssertionError(f"{tag}: rows with no valid key are not 0")
            n_valid = int(mask.sum()) * B * H
            es = q.element_size()
            nbytes = (q.numel() + k.numel() + v.numel() + B * Sq * H * Dv) * es
            qk, pv = 2 * n_valid * D, 2 * n_valid * Dv
            if bf16:  # tensor cores: Q.K^T, and P.V as two bf16 products; the exponentials
                bound_ms, bound_by = _bound(nbytes, 0, qk + 2 * pv, n_valid)
            else:     # CUDA cores: every product at the fp32 rate
                bound_ms, bound_by = _bound(nbytes, qk + pv)
            lib, backends = None, None
            if not window and not cap and off == 0 and (not causal or Sq == Sk):
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=causal, scale=scale, **_sdpa_kw(H, Kv))
                lib = _sdpa(torch, sdpa, tag)
                if D != Dv or D > 128:
                    backends = _sdpa_backends(torch, sdpa)
            elif _window_only(window, cap, off, Sq, Sk):
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                allowed = mask.cuda()
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=allowed, scale=scale, **_sdpa_kw(H, Kv))
                lib = _sdpa(torch, sdpa, tag)
                if lib is not None:
                    backends = _sdpa_backends(torch, sdpa)
            n = 10 if Sq * Sk > 100_000 else 100
            t = _attn_times(torch, lambda: KA.flash_attention(q, k, v, **kw),
                            lambda: ref.flash_attention_ref(q, k, v, **kw), lib, n)
            err = float((got.float() - want.float()).abs().max())
            log(f"[attention] {tag} (B={B} Sq={Sq} Sk={Sk} H={H} Kv={Kv} D={D} Dv={Dv}), "
                f"{took} route: max|err| {err:.2e}"
                + (f", {differ:.4f} of outputs differ from the plain version's" if bf16 else "")
                + (f", {int(dead.sum())} rows with no valid key are 0" if dead.any() else "")
                + "; us per call eager/graph: "
                + ", ".join(f"{w} {_us(e)}/{_us(g)}" for w, (e, g) in t.items())
                + f"; bound {bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B, "
                  f"{qk} flop Q.K^T, {pv} flop P.V, {n_valid} exp)"
                + (f"; SDPA backends that take {_taken(window, D, Dv)}: {backends}"
                   if backends else ""))
            if name in ("encoder", "gemma3 global"):
                rows[f"flash_attention_{took}" + ("_256" if D == 256 else "")] = {
                    "max_abs_err": err, "ms": t["kernel"][0], "plain_ms": t["plain"][0],
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t["library"][0]}
    S_self = K11_SHAPES[0][2]
    split_edges = tuple(("self pos %d" % p, 4, S_self, 8, 8, 64, p, None, False, 0.0)
                        for p in (KD.SPLIT_SLOTS - 1, KD.SPLIT_SLOTS))
    for name, B, S, H, Kv, D, pos, window, ring, cap in K11_SHAPES + split_edges:
        for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, kc, vc = (torch.randn(s, generator=gen, device="cuda").to(dtype) for s in
                         ((B, H, D), (B, S, Kv, D), (B, S, Kv, D)))
            pos_t = torch.full((), pos, dtype=torch.int32, device="cuda")
            kw = dict(window=window, ring=ring, logit_softcap=cap)
            got = KD.flash_decode(q, kc, vc, pos_t, **kw)
            torch.cuda.synchronize()
            want = ref.decode_attention_ref(q, kc, vc, pos_t, **kw)
            tag = f"flash_decode {name} {dname}"
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"{tag}: the kernel broke the shape or dtype contract")
            atol, rtol = ATTN_TOL[dname]
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{tag}: {m}")
            again = KD.flash_decode(q, kc, vc, pos_t, **kw)
            if not torch.equal(again, got):
                raise AssertionError(f"{tag}: a second launch gave other bits")
            n_valid = int(ref.decode_valid(S, pos, window=window, ring=ring).sum())
            es = q.element_size()
            nbytes = (2 * q.numel() + B * Kv * n_valid * 2 * D) * es
            qk = pv = 2 * B * H * n_valid * D  # bounded as K10's CUDA-core route
            bf16 = dtype == torch.bfloat16
            bound_ms, bound_by = _bound(nbytes, pv + (0 if bf16 else qk), qk if bf16 else 0)
            lib = None
            if not ring and not cap:  # the valid slots: the window's, up to pos
                qt = q[:, :, None]
                lo = max(0, pos - window + 1) if window else 0
                kt, vt = (c[:, lo:pos + 1].transpose(1, 2) for c in (kc, vc))
                lib = _sdpa(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, **_sdpa_kw(H, Kv)), tag)
            t = _attn_times(torch, lambda: KD.flash_decode(q, kc, vc, pos_t, **kw),
                            lambda: ref.decode_attention_ref(q, kc, vc, pos_t, **kw), lib, 200)
            err = float((got.float() - want.float()).abs().max())
            log(f"[attention] {tag} (B={B} S={S} H={H} Kv={Kv} D={D} pos={pos}, {n_valid} "
                f"valid slots, {KD.n_splits(S)} splits): max|err| {err:.2e}, bitwise repeatable; "
                "us per call eager/graph: "
                + ", ".join(f"{w} {_us(e)}/{_us(g)}" for w, (e, g) in t.items())
                + f"; bound {bound_ms * 1e3:.2f} us ({bound_by}, {nbytes} B)")
            if dname == "bfloat16" and name in ("cross", "gemma3 serve pos 1183"):
                rows["flash_decode" + ("_256" if D == 256 else "")] = {
                    "max_abs_err": err, "ms": t["kernel"][0], "plain_ms": t["plain"][0],
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t["library"][0]}
    _decode_graph_replay(torch, gen)
    return rows


def _decode_graph_replay(torch, gen) -> None:
    """K11 captured once in a CUDA graph and replayed while pos advances on
    the device between replays, across a split edge and up to the last
    slot of the self cache: each replay's output held to the plain
    version at that pos, which shows that the partials and the tickets
    (returned to 0 by the last block) serve every replay."""
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import ref

    B, S, H, D = 4, K11_SHAPES[0][2], 8, 64
    start = KD.SPLIT_SLOTS - 3
    steps = [start + i for i in range(6)] + [S - 2, S - 1]
    for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        q, kc, vc = (torch.randn(s, generator=gen, device="cuda").to(dtype) for s in
                     ((B, H, D), (B, S, H, D), (B, S, H, D)))
        pos_t = torch.full((), start, dtype=torch.int32, device="cuda")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            KD.flash_decode(q, kc, vc, pos_t)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = KD.flash_decode(q, kc, vc, pos_t)
        atol, rtol = ATTN_TOL[dname]
        worst = 0.0
        for i, pos in enumerate(steps):
            if i > 0:
                pos_t.add_(pos - steps[i - 1])  # on the device, between replays
            graph.replay()
            want = ref.decode_attention_ref(q, kc, vc, pos_t)
            tag = f"[attention] flash_decode graph replay {dname} pos={pos}"
            torch.testing.assert_close(out.float(), want.float(), atol=atol, rtol=rtol,
                                       msg=lambda m: f"{tag}: {m}")
            worst = max(worst, float((out.float() - want.float()).abs().max()))
        log(f"[attention] flash_decode {dname} replayed from one CUDA graph at pos {steps} "
            f"(advanced on the device between replays): every replay matches the plain "
            f"version, max|err| {worst:.2e}")


def _attn_counts() -> dict:
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KA

    return {"flash_attention": KA.FWD_LAUNCHES, "flash_attention_wgmma": KA.WGMMA_LAUNCHES,
            "flash_attention_simt": KA.SIMT_LAUNCHES, "flash_attention_bwd": KA.BWD_LAUNCHES,
            "flash_attention_bwd_wgmma": KA.BWD_WGMMA_LAUNCHES,
            "flash_attention_bwd_simt": KA.BWD_SIMT_LAUNCHES, "flash_decode": KD.FWD_LAUNCHES}


def _wide_counts() -> dict:
    """The launches on the instantiations for heads past 192 and 128 that
    gemma3's heads of 256 take (the tensor-core forward's two warpgroups,
    the backward's column halves, the CUDA-core tiles of 256, K11 sized for
    256 columns), each its own row of the kernels line."""
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.kernels import flash_attention as KA

    return {"flash_attention_wgmma_256": KA.WGMMA_WIDE_LAUNCHES,
            "flash_attention_simt_256": KA.SIMT_WIDE_LAUNCHES,
            "flash_attention_bwd_wgmma_256": KA.BWD_WGMMA_WIDE_LAUNCHES,
            "flash_attention_bwd_simt_256": KA.BWD_SIMT_WIDE_LAUNCHES,
            "flash_decode_256": KD.WIDE_LAUNCHES}


def _wide(route: str, D: int, Dv: int, n: int, bwd: int = 0, dec: int = 0) -> dict:
    """The expected ``_wide_counts`` of ``n`` K10 forward launches and
    ``bwd`` calls of its backward on ``route``, and ``dec`` K11 launches,
    all at widths D, Dv: those that the libraries' ``*_wide`` entries, the
    tests their dispatch branches on, put on the instantiations counted
    apart."""
    from repro_torch.kernels import flash_attention as KA

    wg = route == "wgmma"
    fwd = (KA._lib().flash_attention_wgmma_wide if wg else KA._lib().flash_attention_simt_wide)
    back = (KA._bwd_wgmma_lib().flash_attention_bwd_wgmma_wide if wg
            else KA._bwd_lib().flash_attention_bwd_simt_wide)
    n, bwd = n * fwd(D, Dv), bwd * back(D, Dv)
    return {"flash_attention_wgmma_256": n if wg else 0, "flash_attention_simt_256": 0 if wg else n,
            "flash_attention_bwd_wgmma_256": bwd if wg else 0,
            "flash_attention_bwd_simt_256": 0 if wg else bwd,
            "flash_decode_256": dec * KA._lib().flash_decode_wide(D, Dv)}


def _attn_widths(cfg) -> tuple:
    """A transformer config's K10 widths (D, Dv): multi-head latent
    attention's q·k and v widths, else the head width."""
    m = cfg.mla
    return (cfg.head_dim, cfg.head_dim) if m is None else (m.qk_nope_dim + m.qk_rope_dim, m.v_dim)


def _check_wide(tag: str, want: dict) -> None:
    got = _wide_counts()
    if got != want:
        raise AssertionError(f"{tag}: launches on the wide instantiations {got}, expected {want}")


def _k10(n: int, route: str = "wgmma", bwd: int = 0) -> dict:
    """K10's expected counts: ``n`` forward launches and ``bwd`` calls of
    its backward, all on ``route`` (the two rules agree on the inputs the
    paths give them)."""
    return {"flash_attention": n, "flash_attention_wgmma": n if route == "wgmma" else 0,
            "flash_attention_simt": n if route == "simt" else 0, "flash_attention_bwd": bwd,
            "flash_attention_bwd_wgmma": bwd if route == "wgmma" else 0,
            "flash_attention_bwd_simt": bwd if route == "simt" else 0}


def _check_attn(tag: str, want: dict) -> None:
    got = _attn_counts()
    if got != want:
        raise AssertionError(f"{tag}: attention launches {got}, expected {want}")


# the enc-dec serves: the tiny one (smoke config) is held cuda against cpu
# relative to each output's largest entry (the registry's fp32 serves too),
# fp32 at sums in another order, bf16 at about one bf16 ulp; the whisper-base
# decode against its teacher-forced decoder in bf16 at SERVE_LOGIT_TOL
# relative to the largest logit: the two paths round at other places (K11
# against K10, one token against 64 in each product) through 6 layers
TINY_SERVE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SERVE_LOGIT_TOL = 5e-2
SERVE_B, SERVE_FRAMES, SERVE_STEPS, SERVE_TOTAL = 4, 1500, 60, 448
# Whisper's multilingual start-of-transcript prefix: <|startoftranscript|>,
# <|en|>, <|transcribe|>, <|notimestamps|>
WHISPER_PROMPT = (50258, 50259, 50359, 50363)


def _grow_cache(torch, cfg, cache: dict, total: int, device) -> dict:
    """``prefill``'s caches copied into ``init_cache(B, total)``: a decode
    step straight after ``prefill`` would overwrite its last slot (F6)."""
    from repro_torch.models import encdec

    full = encdec.init_cache(cfg, cache["self_k"].shape[1], total, device=device)
    n = cache["self_k"].shape[2]
    for name in ("self_k", "self_v"):
        full[name][:, :, :n].copy_(cache[name])
    for name in ("cross_k", "cross_v"):
        full[name].copy_(cache[name])
    return full


def _rel(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1.0)


def _margin_agrees(torch, got, want, tol: float):
    """Greedy tokens of ``got`` and ``want`` (logits (..., V)) agree wherever
    want's top-2 margin exceeds ``tol`` times its largest entry. Returns
    (positions checked, positions in all)."""
    top2 = want.float().topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol * max(float(want.float().abs().max()), 1.0)
    same = got.argmax(-1) == want.argmax(-1)
    if not bool(same[sure].all()):
        raise AssertionError(f"greedy tokens differ at {int((~same & sure).sum())} positions "
                             "whose top-2 margin exceeds the tolerance")
    return int(sure.sum()), sure.numel()


def phase_tiny_encdec(torch):
    """The smoke config of whisper-base served on the card and on the CPU
    from the same parameters and inputs, in fp32 and bf16 compute: encode
    and prefill over a 4-token prompt (6 K10 launches), the caches grown to
    16 slots, 8 decode steps (4 K11 launches each) fed the CPU's greedy
    tokens. Every step's logits agree; greedy tokens agree where the
    margin is clear."""
    import numpy as np

    from repro_torch.configs import whisper_base
    from repro_torch.models import encdec

    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(whisper_base.make_smoke_config(), dtype=dname)
        params = encdec.init_params(cfg, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        frames = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32))
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 4)))
        out, fed = {}, None
        for device in ("cpu", "cuda"):
            p = {k: v.to(device) for k, v in params.items()}
            _zero_counts()
            logits, cache = encdec.prefill(cfg, p, frames.to(device), prompt.to(device))
            cache = _grow_cache(torch, cfg, cache, 16, device)
            steps = [logits]
            toks = fed or []
            for i in range(8):
                if fed is None:
                    toks.append(steps[-1].argmax(-1, keepdim=True))
                logits, cache = encdec.decode_step(cfg, p, cache, toks[i].to(device), 4 + i)
                steps.append(logits)
            fed = toks
            out[device] = torch.stack(steps).cpu()
            if device == "cuda":
                # head_dim 16: bf16 takes the tensor cores, fp32 the CUDA cores
                _check_attn(f"[tiny encdec {dname}]",
                            {**_k10(6, "wgmma" if dname == "bfloat16" else "simt"),
                             "flash_decode": 8 * 2 * cfg.dec_layers})
        err = _rel(torch, out["cuda"], out["cpu"])
        if err > TINY_SERVE_TOL[dname]:
            raise AssertionError(f"[tiny encdec {dname}] logits cuda vs cpu: relative error "
                                 f"{err:.2e} > {TINY_SERVE_TOL[dname]}")
        checked, total = _margin_agrees(torch, out["cuda"], out["cpu"], TINY_SERVE_TOL[dname])
        log(f"[tiny encdec {dname}] prefill + 8 decode steps: logits cuda vs cpu relative error "
            f"{err:.2e} (tol {TINY_SERVE_TOL[dname]}); greedy tokens agree at {checked} of "
            f"{total} positions with a clear margin; launches K10 6, K11 "
            f"{8 * 2 * cfg.dec_layers}")


def phase_whisper_serve(torch):
    """whisper-base at full width (70,857,216 bf16 parameters, random from
    a seed) served through the model bundle on the card: 4 utterances of
    1,500 frames, Whisper's 4-token prompt, ``prefill``, the caches grown
    to 448 slots, 60 greedy ``decode_step``s. Exact launch counts (K10 18 in
    prefill, 6 of them in its encode; K11 12 a step), times and peak
    memory; prefill and 10 decode steps again under torch.profiler (the
    busy share and the kernels that fill it); the decode's logits held to
    the teacher-forced ``decode_train`` over the prompt and the generated
    tokens (12 K10 launches), and one teacher-forced ``loss_fn`` forward
    at U=448 (18 K10 launches). Returns the serve path's launch counts."""
    from repro_torch.configs import whisper_base
    from repro_torch.models import encdec, model_zoo

    cfg = whisper_base.make_config()
    bundle = model_zoo.build_model(cfg)
    L = cfg.dec_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = bundle.init(gen)
    n_params = bundle.param_count(params)
    frames = torch.randn((SERVE_B, SERVE_FRAMES, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.cdtype)
    prompt = torch.tensor([WHISPER_PROMPT] * SERVE_B, device="cuda")
    batch = {"frames": frames, "tokens": prompt}
    tag = "[whisper-base serve]"

    def serve():
        logits, cache = bundle.prefill(params, batch)
        cache = _grow_cache(torch, cfg, cache, SERVE_TOTAL, "cuda")
        return logits, cache

    with torch.no_grad():
        logits, cache = serve()  # warm-up: cuBLAS handles, allocator pools
        bundle.decode_step(params, cache, logits.argmax(-1, keepdim=True), len(WHISPER_PROMPT))
        del cache
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        enc_out = encdec.encode(cfg, params, frames)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        _check_attn(f"{tag} encode", {**_k10(cfg.enc_layers), "flash_decode": 0})

        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the weights, frames, enc_out, earlier phases'
        _zero_counts()
        t0 = time.perf_counter()
        logits, cache = serve()
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        steps, fed = [logits], []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(SERVE_STEPS):
            fed.append(steps[-1].argmax(-1, keepdim=True))
            logits, cache = bundle.decode_step(params, cache, fed[-1], len(WHISPER_PROMPT) + i)
            steps.append(logits)
        end.record()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = _attn_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {**_k10(cfg.enc_layers + 2 * L), "flash_decode": 2 * L * SERVE_STEPS}
        _check_attn(f"{tag} prefill + {SERVE_STEPS} decode steps", want)
        del cache

        # where the time goes: prefill, then 10 decode steps, under the profiler
        from torch.profiler import ProfilerActivity, profile

        windows = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only
            t0 = time.perf_counter()
            out, cache = serve()
            torch.cuda.synchronize()
            windows["prefill"] = (prof, prefill_s, time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(10):
                out, cache = bundle.decode_step(params, cache, out.argmax(-1, keepdim=True),
                                                len(WHISPER_PROMPT) + i)
            torch.cuda.synchronize()
            windows["10 decode steps"] = (prof, 10 * decode_s / SERVE_STEPS,
                                          time.perf_counter() - t0)
        del cache, out
        for what, (prof, wall, wall_prof) in windows.items():
            _log_profile(tag, _device_times(torch, prof), wall, wall_prof, what=what)

        # the decode against the teacher-forced decoder on the same encoder output
        tokens = torch.cat([prompt, *fed], dim=1)                  # (B, 64)
        _zero_counts()
        h = encdec.decode_train(cfg, params, tokens, enc_out)
        _check_attn(f"{tag} decode_train", {**_k10(2 * L), "flash_decode": 0})
        n0 = len(WHISPER_PROMPT) - 1
        tf = (h[:, n0:] @ params["tok_embed"].to(cfg.cdtype).T).float().transpose(0, 1)
        dec = torch.stack(steps)                                   # (61, B, V)
        if dec.shape != tf.shape or not torch.isfinite(dec).all():
            raise AssertionError(f"{tag} decode logits {tuple(dec.shape)} are not finite or "
                                 f"not shaped as the teacher-forced {tuple(tf.shape)}")
        err = _rel(torch, dec, tf)
        if err > SERVE_LOGIT_TOL:
            raise AssertionError(f"{tag} decode logits against decode_train: relative error "
                                 f"{err:.3e} > {SERVE_LOGIT_TOL}")
        checked, total = _margin_agrees(torch, dec, tf, SERVE_LOGIT_TOL)

        # one teacher-forced loss forward at the 448 target positions
        g2 = torch.Generator(device="cuda").manual_seed(1)
        lbatch = {"frames": frames, "tokens": torch.randint(0, cfg.vocab, (SERVE_B, SERVE_TOTAL),
                                                            generator=g2, device="cuda")}
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = bundle.loss_fn(params, lbatch)
        loss = float(loss)
        loss_s = time.perf_counter() - t0
        _check_attn(f"{tag} loss_fn U={SERVE_TOTAL}",
                    {**_k10(cfg.enc_layers + 2 * L), "flash_decode": 0})
        if not math.isfinite(loss):
            raise AssertionError(f"{tag} loss_fn gave {loss}")
    log(f"{tag} {n_params} parameters ({cfg.pdtype}); B={SERVE_B} x {SERVE_FRAMES} frames, "
        f"{len(WHISPER_PROMPT)}-token prompt, {SERVE_STEPS} greedy steps: encode "
        f"{encode_s * 1e3:.2f} ms, prefill (with its encode, and the cache copy to "
        f"{SERVE_TOTAL} slots) {prefill_s * 1e3:.2f} ms, decode {decode_s * 1e3 / SERVE_STEPS:.3f} "
        f"ms per token on the host clock ({start.elapsed_time(end) / SERVE_STEPS:.3f} ms between "
        f"CUDA events), {SERVE_B * SERVE_STEPS / decode_s:.1f} tokens/s; peak memory over "
        f"prefill and decode {peak} B, {peak - held} B above the {held} B allocated before "
        f"it; launches K10 {launches['flash_attention']}, all on the tensor cores (encode "
        f"{cfg.enc_layers}), K11 {launches['flash_decode']} ({2 * L} a step)")
    log(f"{tag} decode vs teacher-forced decode_train ({2 * L} K10 launches) over "
        f"{tokens.shape[1]} tokens: logits relative error {err:.3e} (tol {SERVE_LOGIT_TOL}); "
        f"greedy tokens agree at {checked} of {total} positions with a clear margin; loss_fn "
        f"at U={SERVE_TOTAL}: {loss:.4f} in {loss_s * 1e3:.1f} ms, "
        f"{cfg.enc_layers + 2 * L} K10 launches")
    return launches


# whisper-base's federated training in phase 5: K=4 clients, b=4, 2 local
# steps (data limit 8), FVN std 0.01, two rounds, then the perplexity
# evaluation on 16 examples of each split and the per-client panel (6
# clients x 4 examples)
WHISPER_ARGV = ["--task", "whisper-base", "--clients", "4", "--batch", "4", "--data-limit", "8",
                "--fvn-std", "0.01", "--eval-every", "0"]
WHISPER_EVAL_EXAMPLES = 16
# the first round's loss on the kernels against the same round with K10's
# forward and backward swapped for their plain versions on the card: the
# bf16 attention outputs differ by an ulp in at most 2 % of entries
# (K10_BF16_DIFF_MAX) and the gradients by an ulp (ATTN_BWD_TOL), carried
# through 12 layers and a local SGD step in bf16
WHISPER_LOSS_RTOL = 5e-3


@contextlib.contextmanager
def _attention_swapped(replacement):
    """Every attention of the model (``models/attention.py``'s
    ``blockwise_attention`` calls ``flash_attention`` by name) calls
    ``replacement`` inside the block."""
    from repro_torch.models import attention

    saved = attention.flash_attention
    attention.flash_attention = replacement
    try:
        yield
    finally:
        attention.flash_attention = saved


def _plain_attention_on_card():
    """Every attention of the model takes K10's plain version on the card
    inside the block, under autograd: its forward and its backward are
    plain PyTorch."""
    from repro_torch.kernels import ref

    return _attention_swapped(ref.flash_attention_ref)


def phase_whisper_train(torch):
    """whisper-base trained at full width (70,857,216 bf16 parameters,
    random from a seed) through the training entry point on a corpus at its
    widths (``whisper_width_corpus``: frames 512 wide, T = 384, U = 48,
    51,865 word-pieces; its build timed and sized): two FedAvg rounds with
    FVN, exact launches (K10's forward 18 a client step and its backward
    18, all on the tensor cores; the normal kernel once), round times,
    examples per second and peak memory; the final perplexity evaluation
    (16 examples of each split, 36 K10 launches) and the per-client panel
    (6 x 4, 216 K10 launches: its loss and its perplexity), each timed; one more round under
    torch.profiler (device time, busy share, K10's backward's device time
    by launch); the first round again with
    K10's forward and backward swapped for their plain versions on the card
    (no K10 launch), its loss within WHISPER_LOSS_RTOL of the kernels'.
    Returns the training rounds' launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.clienteval import ClientEvalPlane
    from repro_torch.core.task import get_task
    from repro_torch.launch import train

    task = get_task("whisper-base")
    cfg, rounds = task.config, 2
    tag = "[whisper-base train]"
    t0 = time.perf_counter()
    corpus = task.make_corpus(0)
    build_s = time.perf_counter() - t0
    arena = sum(a.nbytes for a in (corpus.arena_features, corpus.arena_labels,
                                   corpus.arena_label_len, corpus.arena_frame_len))
    log(f"{tag} corpus built in {build_s:.1f} s: token codebook {corpus.codebook.nbytes} B, "
        f"arena {tuple(corpus.arena_features.shape)} {arena} B on the host "
        f"({int(corpus.counts.sum())} utterances, T={corpus.t_max}, U={corpus.u_max})")
    args = train.parse_args(WHISPER_ARGV + ["--rounds", str(rounds)])
    plan = train.build_plan(args)
    marks = []

    def after_round(line):
        log(f"{tag} {line}")
        marks.append((_counts(), torch.cuda.max_memory_allocated()))

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, hist = train.run_federated(task, corpus, plan, rounds, seed=0, device="cuda",
                                      eval_every=0, eval_examples=WHISPER_EVAL_EXAMPLES,
                                      log=after_round)
    torch.cuda.synchronize()
    total = _counts()
    trained, train_peak = marks[-1]
    evaluated = {k: total[k] - trained[k] for k in total}
    steps = args.clients * hist["local_steps"] * rounds
    calls = cfg.enc_layers + 2 * cfg.dec_layers
    want = {k: 0 for k in total}
    want.update(_k10(calls * steps, bwd=calls * steps), threefry_normal=steps)
    if trained != want:
        raise AssertionError(f"{tag} launches over the training rounds {trained}, expected "
                             f"{want} ({steps} client steps)")
    want_eval = {k: 0 for k in total}
    want_eval.update(_k10(2 * calls))
    if evaluated != want_eval:
        raise AssertionError(f"{tag} launches over the evaluation {evaluated}, expected "
                             f"{want_eval}")
    ppl = (hist["quality"], hist["quality_hard"])
    if not all(math.isfinite(x) for x in hist["loss"]) or hist["quality_metric"] != "ppl" or \
            not all(math.isfinite(x) and x >= 1.0 for x in ppl) or \
            hist["n_params"] != 70_857_216:
        raise AssertionError(f"{tag} losses {hist['loss']}, {hist['quality_metric']} {ppl}, "
                             f"{hist['n_params']} parameters")

    plane = ClientEvalPlane(task, corpus, clients=6, n=4)
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = plane.measure(state.params)
    torch.cuda.synchronize()
    panel_s = time.perf_counter() - t0
    # the loss and the perplexity hooks each run every client's forward,
    # as the reference's plane does (its jitted loss, then client_quality's)
    panel_calls = 2 * len(plane.client_ids) * calls
    want_panel = {k: 0 for k in total}
    want_panel.update(_k10(panel_calls))
    if _counts() != want_panel or not all(map(math.isfinite, rec["client_loss"])) or \
            not all(rec["client_quality"] >= 1.0):
        raise AssertionError(f"{tag} panel launches {_counts()}, expected {want_panel}; "
                             f"losses {rec['client_loss']}, perplexities {rec['client_quality']}")
    del state

    args1 = train.parse_args(WHISPER_ARGV + ["--rounds", "1"])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only
        _, hist_prof = train.run_federated(task, corpus, train.build_plan(args1), 1, seed=0,
                                           device="cuda", eval_every=0, eval_examples=0,
                                           log=lambda line: None)
        torch.cuda.synchronize()
    by_name = _device_times(torch, prof)
    _log_profile(tag, by_name, hist["round_s"][-1], hist_prof["round_s"][0])
    bwd = {n: tn for n, tn in by_name.items() if "fa_bwd_" in n}
    log(f"{tag} K10's backward in the profiled round: "
        f"{sum(t for t, _ in bwd.values()) / 1e3:.3f} ms of device time in "
        f"{sum(c for _, c in bwd.values())} launches ("
        + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms {c}x" for n, (t, c) in
                    sorted(bwd.items(), key=lambda kv: -kv[1][0])) + ")")
    _zero_counts()
    with _plain_attention_on_card():
        _, hist_plain = train.run_federated(task, corpus, train.build_plan(args1), 1, seed=0,
                                            device="cuda", eval_every=0, eval_examples=0,
                                            log=lambda line: None)
    torch.cuda.synchronize()
    plain_k10 = {k: v for k, v in _counts().items() if k.startswith("flash_attention") and v}
    loss_k, loss_p = hist["loss"][0], hist_plain["loss"][0]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    if plain_k10 or rel > WHISPER_LOSS_RTOL:
        raise AssertionError(f"{tag} first-round loss on K10 {loss_k} against the plain "
                             f"attention on the card {loss_p}: relative gap {rel:.3e} (tol "
                             f"{WHISPER_LOSS_RTOL}); K10 launches in the plain run {plain_k10}")
    per_s = [e / t for e, t in zip(hist["examples"], hist["round_s"])]
    log(f"{tag} {hist['n_params']} parameters ({cfg.pdtype}), K={args.clients} b={args.batch} "
        f"{hist['local_steps']} local steps, FVN {args.fvn_std}: losses {hist['loss']}; ms per "
        f"round {[round(t * 1e3, 1) for t in hist['round_s']]}; client examples per second "
        f"{per_s}; peak memory over the training rounds {train_peak} B")
    log(f"{tag} launches per client step over {steps} client steps: "
        + ", ".join(f"{k} {v / steps:g}" for k, v in trained.items() if v))
    log(f"{tag} final evaluation ({WHISPER_EVAL_EXAMPLES} examples of each split): "
        f"{hist['eval_s'] * 1e3:.1f} ms, perplexity {ppl[0]:.2f} clean, {ppl[1]:.2f} hard; "
        f"launches {({k: v for k, v in evaluated.items() if v})}")
    log(f"{tag} panel {plane.client_ids.tolist()} x 4 examples: {panel_s * 1e3:.1f} ms "
        f"(synchronised), {panel_calls} K10 launches; losses "
        f"{[round(float(x), 4) for x in rec['client_loss']]}, spread {plane.spread()}")
    log(f"{tag} first-round loss on K10 {loss_k} vs K10's plain versions on the card {loss_p}: "
        f"relative gap {rel:.3e} (tol {WHISPER_LOSS_RTOL}), no K10 launch in the plain run; "
        f"its round {hist_plain['round_s'][0] * 1e3:.1f} ms against the kernels' last "
        f"{hist['round_s'][-1] * 1e3:.1f} ms")
    return trained


# the tiny LM and keyword rounds of phase 4: K=4 clients, b=4, data limit 8
# (2 local steps), FVN 0.01, server SGD at lr 1, card against CPU from the
# same parameters and batch; the loss to TINY_LM_LOSS_RTOL relative, the
# aggregated delta to TINY_LM_DELTA_ATOL (fp32 sums in other orders: the
# card's K10 and cuBLAS against the CPU's plain versions)
TINY_LM_TASKS = ("lm-transformer", "lm-moe", "keyword", "lm-rwkv", "zamba2-7b-smoke",
                 "deepseek-v2-lite-16b-smoke", "gemma3-4b-d256-smoke")
TINY_LM_LOSS_RTOL = 1e-4
TINY_LM_DELTA_ATOL = 1e-5
# lm-rwkv's aggregated delta (entries up to 0.31, against the transformers'
# 0.04) goes through a group norm and two layer norms over 16-wide heads
# that amplify fp32 sum-order differences: its card and CPU rounds were
# 1.79e-05 apart (NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6), and on the
# CPU alone JAX's own
# fp32 gradient at rwkv6-1.6b's smoke config is 2.4e-05 from an fp64 run
# (tests/test_torch_rwkv.py)
TINY_LM_DELTA_ATOL_BY_TASK = {"lm-rwkv": 5e-5}


def _tiny_lm_task(name: str):
    """A registered task, or zamba2-7b's or deepseek-v2-lite-16b's smoke
    config on the shared corpus (the hybrid's and MLA's tiny tasks: the
    reference registers none; deepseek's smoke MLA runs K10 at D = 48, Dv =
    32 in fp32, on the CUDA-core routes), or gemma3's at gemma3-4b's head
    width (``gemma3_d256_smoke``: K10's CUDA-core routes at tiles of 256)."""
    from repro_torch.configs import deepseek_v2_lite_16b, zamba2_7b
    from repro_torch.core.task import get_task, task_for_config

    smoke = {"zamba2-7b-smoke": zamba2_7b.make_smoke_config,
             "deepseek-v2-lite-16b-smoke": deepseek_v2_lite_16b.make_smoke_config,
             "gemma3-4b-d256-smoke": gemma3_d256_smoke}
    if name in smoke:
        return task_for_config(smoke[name](), name=name)
    return get_task(name)


def gemma3_d256_smoke():
    """gemma3's smoke config (2 layers: one local of window 16, one global;
    fp32) at gemma3-4b's head width: 2 heads on 1 kv head of 256, as
    tests/test_torch_gemma3.py holds it against the JAX package."""
    from repro_torch.configs import gemma3_4b

    return dataclasses.replace(gemma3_4b.make_smoke_config(), head_dim=256, n_heads=2, n_kv=1)


def _lm_step_launches(task, steps: int, route: str, backward: bool = True) -> dict:
    """The launches of ``steps`` client steps of an LM task's training:
    K10's forward and backward once an attention (a transformer layer, an
    application of the hybrid's shared block) on ``route``, K12 forward and
    backward once an RWKV layer, K13 once a Mamba2 layer, the normal kernel
    once (FVN). ``backward`` False: ``steps`` forwards alone (an
    evaluation's), no backward and no FVN draw."""
    cfg = task.config
    bwd = steps if backward else 0
    want = {"threefry_normal": steps} if backward else {}
    if task.kind in ("dense", "moe"):
        want.update(_k10(cfg.n_layers * steps, route, bwd=cfg.n_layers * bwd))
        D, Dv = _attn_widths(cfg)
        want.update(_wide(route, D, Dv, cfg.n_layers * steps, bwd=cfg.n_layers * bwd))
    elif task.kind == "hybrid":
        apps = cfg.n_attn_applications
        want.update(_k10(apps * steps, route, bwd=apps * bwd), ssm_scan_fwd=cfg.n_layers * steps,
                    ssm_scan_bwd=cfg.n_layers * bwd)
    elif task.kind == "ssm":
        want.update(wkv6_fwd=cfg.n_layers * steps, wkv6_bwd=cfg.n_layers * bwd)
    return want


def phase_tiny_lm_rounds(torch):
    """One FedAvg round of each of the reference's container-scale LM, MoE
    LM, RWKV LM and keyword tasks, of zamba2-7b's smoke hybrid and of
    deepseek-v2-lite-16b's smoke MLA transformer (fp32, FVN on) on the card
    and on the CPU from the same parameters and batch: the loss and the
    aggregated delta agree. On the card each attention runs
    K10's CUDA-core route (fp32) and its CUDA-core backward, each RWKV
    layer K12 and each Mamba2 layer K13, forward and backward, once a
    client step (exact launches, ``_lm_step_launches``); every task
    launches the normal kernel once a client step. gemma3's smoke config
    at heads of 256 takes the CUDA-core routes' tiles of 256. Returns the
    card rounds' launches, summed."""
    from repro_torch.core.engine import build_round_engine
    from repro_torch.core.plan import FederatedPlan, FVNConfig
    from repro_torch.data import FederatedSampler

    K, b, limit = 4, 4, 8
    plan = FederatedPlan(clients_per_round=K, local_batch_size=b, data_limit=limit,
                         client_lr=0.05, server_optimizer="sgd", server_lr=1.0,
                         fvn=FVNConfig(enabled=True, std=0.01))
    summed: dict = {}
    for name in TINY_LM_TASKS:
        task = _tiny_lm_task(name)
        params = task.init_params(torch.Generator().manual_seed(0))
        rb = FederatedSampler(task.make_corpus(0), K, b, data_limit=limit, seed=0).next_round()
        batch = rb.engine_batch()
        steps = K * rb.mask.shape[1]
        out = {}
        for device in ("cuda", "cpu"):
            p = {k: v.to(device) for k, v in params.items()}
            engine = build_round_engine(plan, task, seed=1)
            _zero_counts()
            state, metrics = engine.step(engine.init_state(p),
                                         {k: torch.from_numpy(v).to(device)
                                          for k, v in batch.items()})
            if device == "cuda":
                torch.cuda.synchronize()
                counts = _counts()
                want = {k: 0 for k in counts}
                want.update(_lm_step_launches(task, steps, "simt"))
                if counts != want:
                    raise AssertionError(f"[tiny {name} round] launches "
                                         f"{ {k: v for k, v in counts.items() if v} }, expected "
                                         f"{ {k: v for k, v in want.items() if v} } over "
                                         f"{steps} client steps")
                summed = {k: summed.get(k, 0) + v for k, v in counts.items()}
            out[device] = (metrics["loss"], {k: (p[k] - state.params[k]).cpu() for k in p})
        (loss_c, delta_c), (loss_h, delta_h) = out["cuda"], out["cpu"]
        if not math.isclose(loss_c, loss_h, rel_tol=TINY_LM_LOSS_RTOL):
            raise AssertionError(f"[tiny {name} round] loss cuda {loss_c} vs cpu {loss_h}")
        err = max(float((delta_c[k] - delta_h[k]).abs().max()) for k in delta_c)
        moved = max(float(d.abs().max()) for d in delta_h.values())
        atol = TINY_LM_DELTA_ATOL_BY_TASK.get(name, TINY_LM_DELTA_ATOL)
        if err > atol or not moved > 0:
            raise AssertionError(f"[tiny {name} round] aggregated delta differs by {err:.2e} "
                                 f"(> {atol}) or is 0 ({moved:.2e})")
        log(f"[tiny {name} round] loss cuda {loss_c:.6f} cpu {loss_h:.6f} (rtol "
            f"{TINY_LM_LOSS_RTOL}); aggregated delta max|err| {err:.2e} (atol "
            f"{atol}, delta up to {moved:.2e}); launches a client step over "
            f"{steps} client steps: "
            + ", ".join(f"{k} {v // steps}" for k, v in want.items() if v)
            + " (K10 on its CUDA-core routes, fp32)")
    return summed


@dataclasses.dataclass(frozen=True)
class LMRun:
    """One full-size language model's federated training in phase 5
    (``phase_lm_train``): the task, its driver flags, its parameter count,
    the kernels' template instantiations that the profiled round must show
    (name: launches a client step; every device kernel named as one of them
    up to its template arguments must be one of them), the context that
    swaps the path's kernels for their plain versions on the card, the
    first round's loss's tolerance against that plain run (None: printed,
    not held), and the tolerance of one forward's loss against the plain
    versions'. The kernels' launches a client step and over the evaluation
    (one forward of each split) are ``_lm_step_launches``'. A round's loss
    follows the local steps' gradients, which an ill-conditioned model
    (rwkv6-1.6b at init: tools/recurrent_grad_gaps.py) turns far from one
    run to the other; one forward is the kernels' own measure there."""
    task: str
    argv: tuple
    n_params: int
    insts: dict
    plain: Callable         # () -> context manager
    loss_rtol: Optional[float]
    forward_rtol: float


def phase_lm_train(torch, run: LMRun):
    """A full-size LM task trained through the training entry point on a
    corpus at its vocabulary (label rows of 128 tokens; its build timed):
    two FedAvg rounds (K=4, b=4, 2 local steps, FVN 0.01) with exact
    launches a client step, round times, client examples per second and
    peak memory; the final perplexity evaluation (64 examples of each
    split); one more round under torch.profiler (``_profiled_round``:
    device time by kernel, busy share, the instantiations ``run.insts``);
    the first round again
    with the path's kernels swapped for their plain versions on the card
    (none of them launched), its loss within ``run.loss_rtol`` of the
    kernels'; and the trained model's loss over 4 rows of the eval split,
    one forward on the kernels and one on their plain versions, within
    ``run.forward_rtol``. The perplexity must be below its clip (exp 20).
    Returns (the training rounds' launch counts, the trained parameters, the
    corpus)."""
    from repro_torch.core.task import get_task
    from repro_torch.launch import train

    task = get_task(run.task)
    cfg, rounds = task.config, 2
    tag = f"[{run.task} train]"
    t0 = time.perf_counter()
    corpus = task.make_corpus(0)
    build_s = time.perf_counter() - t0
    log(f"{tag} corpus built in {build_s:.1f} s: token codebook {corpus.codebook.nbytes} B, "
        f"labels {tuple(corpus.arena_labels.shape)} ({int(corpus.counts.sum())} utterances, "
        f"U={corpus.u_max}, vocab {corpus.cfg.vocab_size})")
    args = train.parse_args(list(run.argv) + ["--rounds", str(rounds)])
    plan = train.build_plan(args)
    marks = []

    def after_round(line):
        log(f"{tag} {line}")
        torch.cuda.synchronize()
        marks.append((_counts(), torch.cuda.max_memory_allocated()))

    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_counts()
    state, hist = train.run_federated(task, corpus, plan, rounds, seed=0, device="cuda",
                                      eval_every=0, eval_examples=LM_EVAL_EXAMPLES,
                                      log=after_round)
    torch.cuda.synchronize()
    total, eval_peak = _counts(), torch.cuda.max_memory_allocated()
    trained, train_peak = marks[-1]
    evaluated = {k: total[k] - trained[k] for k in total}
    steps = args.clients * hist["local_steps"] * rounds
    want = {k: 0 for k in total}
    want.update(_lm_step_launches(task, steps, "wgmma"))
    if trained != want:
        raise AssertionError(f"{tag} launches over the training rounds "
                             f"{ {k: v for k, v in trained.items() if v} }, expected "
                             f"{ {k: v for k, v in want.items() if v} } ({steps} client steps)")
    want_eval = {k: 0 for k in total}
    want_eval.update(_lm_step_launches(task, 2, "wgmma", backward=False))
    if evaluated != want_eval:
        raise AssertionError(f"{tag} launches over the evaluation "
                             f"{ {k: v for k, v in evaluated.items() if v} }, expected "
                             f"{ {k: v for k, v in want_eval.items() if v} }")
    ppl = (hist["quality"], hist["quality_hard"])
    if not all(math.isfinite(x) for x in hist["loss"]) or hist["quality_metric"] != "ppl" or \
            not all(1.0 <= x < math.exp(20.0) for x in ppl) or \
            hist["n_params"] != run.n_params:
        raise AssertionError(f"{tag} losses {hist['loss']}, {hist['quality_metric']} {ppl}, "
                             f"{hist['n_params']} parameters")
    params = {k: v.detach() for k, v in state.params.items()}
    del state
    torch.cuda.synchronize()

    args1 = train.parse_args(list(run.argv) + ["--rounds", "1"])
    # each run's state (parameters, the server's Adam moments) is dropped as
    # it returns: two would not fit on the card beside the next run
    want_round = {k: 0 for k in total}
    want_round.update(_lm_step_launches(task, steps // rounds, "wgmma"))
    _profiled_round(torch, tag, lambda: train.run_federated(
        task, corpus, train.build_plan(args1), 1, seed=0, device="cuda", eval_every=0,
        eval_examples=0, log=lambda line: None)[1]["round_s"][0],
        hist["round_s"][-1], run.insts, steps // rounds, want_round)
    _zero_counts()
    with run.plain():
        hist_plain = train.run_federated(task, corpus, train.build_plan(args1), 1, seed=0,
                                         device="cuda", eval_every=0, eval_examples=0,
                                         log=lambda line: None)[1]
    torch.cuda.synchronize()
    ours = set(_lm_step_launches(task, 1, "wgmma")) - {"threefry_normal"}
    plain_launches = {k: v for k, v in _counts().items() if k in ours and v}
    loss_k, loss_p = hist["loss"][0], hist_plain["loss"][0]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    if plain_launches or (run.loss_rtol is not None and rel > run.loss_rtol):
        raise AssertionError(f"{tag} first-round loss on the kernels {loss_k} against their "
                             f"plain versions on the card {loss_p}: relative gap {rel:.3e} (tol "
                             f"{run.loss_rtol}); kernel launches in the plain run "
                             f"{plain_launches}")
    from repro_torch.core.task import _eval_batch

    batch = _eval_batch(corpus.eval_split(4), "cuda")
    with torch.no_grad():
        _zero_counts()
        fwd_k = float(task.loss_fn(params, batch)[0])
        fwd_launches = {k: v for k, v in _counts().items() if k in ours and v}
        with run.plain():
            _zero_counts()
            fwd_p = float(task.loss_fn(params, batch)[0])
    plain_launches = {k: v for k, v in _counts().items() if k in ours and v}
    fwd_rel = abs(fwd_k - fwd_p) / abs(fwd_p)
    if plain_launches or not fwd_launches or fwd_rel > run.forward_rtol:
        raise AssertionError(f"{tag} one forward's loss on the kernels {fwd_k} ({fwd_launches}) "
                             f"against their plain versions {fwd_p}: relative gap "
                             f"{fwd_rel:.3e} (tol {run.forward_rtol}); kernel launches in the "
                             f"plain forward {plain_launches}")
    per_s = [e / t for e, t in zip(hist["examples"], hist["round_s"])]
    log(f"{tag} {hist['n_params']} parameters ({cfg.pdtype}) in {len(params)} leaves, "
        f"K={args.clients} b={args.batch} {hist['local_steps']} local steps over "
        f"{corpus.u_max}-token rows, FVN {args.fvn_std}: losses {hist['loss']}; ms per round "
        f"{[round(t * 1e3, 1) for t in hist['round_s']]}; client examples per second {per_s}; "
        f"peak memory over the training rounds {train_peak} B ({held} B allocated before "
        f"them), over the evaluation too {eval_peak} B")
    log(f"{tag} launches per client step over {steps} client steps: "
        + ", ".join(f"{k} {v / steps:g}" for k, v in trained.items() if v))
    log(f"{tag} final evaluation (n = {LM_EVAL_EXAMPLES} examples of each split): "
        f"{hist['eval_s'] * 1e3:.1f} ms, perplexity {ppl[0]:.2f} clean, {ppl[1]:.2f} hard; "
        f"launches {({k: v for k, v in evaluated.items() if v})}")
    log(f"{tag} first-round loss on the kernels {loss_k} vs their plain versions on the card "
        f"{loss_p}: relative gap {rel:.3e} ("
        + (f"tol {run.loss_rtol}" if run.loss_rtol is not None else "printed, not held")
        + "), none of them launched in "
        f"the plain run; its round {hist_plain['round_s'][0] * 1e3:.1f} ms against the "
        f"kernels' last {hist['round_s'][-1] * 1e3:.1f} ms")
    log(f"{tag} the trained model's loss over 4 eval rows, one forward: {fwd_k} on the "
        f"kernels ({fwd_launches}), {fwd_p} on their plain versions: relative gap "
        f"{fwd_rel:.3e} (tol {run.forward_rtol})")
    return trained, params, corpus


# profiled rounds taken at most while the profiler's record of a round holds
# fewer launches of the path's kernels than their counts
PROFILE_TRIES = 3


def _profiled_round(torch, tag: str, go, round_s: float, insts: dict, round_steps: int,
                    want: dict) -> None:
    """``go()`` (one more round; returns its wall seconds) under
    torch.profiler (device events only), the counts set to 0 just before
    and held equal to ``want`` just after; its busy share against the
    unprofiled ``round_s`` (``_log_profile``) and its record of the path's
    kernels (``_check_insts``). The profiler can lose records: a round of
    rwkv6-1.6b holds about 63,000 device events, and its record has come
    back without the last client step's tail while the counts held every
    launch. So where the record lacks launches that the counts show, the
    round is profiled again, at most PROFILE_TRIES times, and the last
    record is kept with its loss printed."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        _zero_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only
            profiled_s = go()
            torch.cuda.synchronize()
        counts = _counts()
        if counts != want:
            raise AssertionError(f"{tag} launches over the profiled round "
                                 f"{ {k: v for k, v in counts.items() if v} }, expected "
                                 f"{ {k: v for k, v in want.items() if v} }")
        by_name = _device_times(torch, prof)
        _log_profile(tag, by_name, round_s, profiled_s)
        lost = _check_insts(tag, by_name, insts, round_steps)
        if not lost:
            return
        log(f"{tag} profiled round {attempt} of at most {PROFILE_TRIES}: the profiler's "
            f"record lacks {lost} of the path's launches that the counts hold"
            + ("; profiling the round again" if attempt < PROFILE_TRIES else
               "; its busy share above counts only the recorded events"))


def _check_insts(tag: str, by_name: dict, insts: dict, round_steps: int) -> int:
    """A profiled round's record of the path's kernels by template
    instantiation: each of ``insts`` (name: launches a client step) seen,
    at most its launches times ``round_steps`` client steps, and no other
    instantiation of those kernels; their device time printed. Returns the
    launches the record lacks (0 where it holds them all, and where the
    profiler recorded no device events: ``_log_profile`` says so)."""
    if not by_name:
        return 0
    select = {inst.split("<")[0] for inst in insts}
    seen = {n: c for n, (_, c) in by_name.items() if any(x in n for x in select)}
    want = {inst: c * round_steps for inst, c in insts.items()}
    got = {inst: sum(c for n, c in seen.items() if inst in n) for inst in insts}
    other = {n: c for n, c in seen.items() if not any(inst in n for inst in insts)}
    if other or any(not 0 < got[inst] <= want[inst] for inst in insts):
        raise AssertionError(f"{tag} the path's kernels in the profiled round {seen}, "
                             f"expected {want}")
    log(f"{tag} the path's kernels in the profiled round by instantiation: "
        + ", ".join(f"{inst} {c} of {want[inst]} ({want[inst] // round_steps} a client step, "
                    f"{sum(t for n, (t, _) in by_name.items() if inst in n) / 1e3:.3f} ms)"
                    for inst, c in got.items()))
    return sum(want.values()) - sum(got.values())


@contextlib.contextmanager
def _plain_recurrences_on_card():
    """K12 and K13 take their plain versions on the card inside the block
    (the wrappers' device check answers "not on the card" after its other
    checks): their forward and their backward are plain PyTorch, the same
    Functions and checkpoints."""
    from repro_torch.kernels import ssm_scan as K13
    from repro_torch.kernels import wkv6 as K12

    saved = (K12._check, K13._check)

    def plain(check):
        return lambda *a: check(*a) and False

    K12._check, K13._check = plain(saved[0]), plain(saved[1])
    try:
        yield
    finally:
        K12._check, K13._check = saved


@contextlib.contextmanager
def _plain_kernels_on_card():
    with _plain_attention_on_card(), _plain_recurrences_on_card():
        yield


# the serve: B=4 prompts of 128 tokens (eval-split label rows), prefill, the
# cache grown to 160 slots, 32 greedy decode steps; each step's logits held to
# a teacher-forced forward over prompt and generated tokens at QWEN_SERVE_TOL
# of the largest logit (K11 against K10, one token against 160 in each
# product, bf16 through 4 layers)
QWEN_SERVE_B, QWEN_PROMPT, QWEN_STEPS = 4, 128, 32
QWEN_SERVE_TOL = 5e-2
# an MoE model's teacher-forced forward at capacity_factor = E / k plus this:
# int(cf · S · k / E) = S, so no expert can overflow at any length (E / k
# alone can round to S - 1)
NO_DROP_MARGIN = 1e-3
# the most of an MoE serve's 132 positions that the decode, or the floor's
# forward, may route to other experts than the teacher-forced forward: a
# rounding apart moves a token's k-th choice now and then (deepseek-v2-lite-
# 16b's bf16 decode 6 of 132, an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6);
# a wrong decode reroutes most of them
MAX_REROUTED_SHARE = 0.1


# the full-size LM tasks' training runs in phase 5 (LM_ARGV, K=4, b=4, 2
# local steps, FVN 0.01, two rounds, the evaluation on LM_EVAL_EXAMPLES of
# each split). The server's Adam at an LM's learning rate, 1e-5: at
# launch/train.py's default of 0.01 (the RNN-T's), the warm-up's second step
# alone moves every weight by up to about 0.005, a third of qwen3-8b's
# projections' init std (4096 ** -0.5), and the evaluation's loss passed the
# perplexity clip (exp 20)
LM_ARGV = ("--clients", "4", "--batch", "4", "--data-limit", "8", "--fvn-std", "0.01",
           "--server-lr", "1e-5", "--eval-every", "0")
LM_EVAL_EXAMPLES = 64
# qwen3-8b at 4 of its 36 layers: K10's forward <2, 128> and its backward
# <2, 2> (64-column regions) once a layer a client step; its first loss
# against the plain attention's: bf16 attention outputs an ulp apart in a few
# entries, carried through 4 layers and a local SGD step
QWEN_RUN = LMRun(
    task="qwen3-8b", argv=("--task", "qwen3-8b") + LM_ARGV, n_params=2_016_449_536,
    insts={"flash_attention_wgmma_kernel<2, 128>": 4, "fa_bwd_dkdv_wgmma_kernel<2, 2>": 4,
           "fa_bwd_dq_wgmma_kernel<2, 2>": 4},
    plain=_plain_attention_on_card, loss_rtol=1e-3, forward_rtol=1e-3)
# rwkv6-1.6b at its full size (24 layers): K12's forward and backward once a
# layer a client step (each backward a recurrence launch and du's sum). Its
# first round's loss against the plain versions' is printed, not held: at
# init the model turns fp32 sums' order into gaps no limit can tell from a
# fault (tools/recurrent_grad_gaps.py on an NVIDIA H100 80GB HBM3 at 700 W,
# PERF.md §6: one local SGD step put the bf16 losses 2.6e-02 apart at lr
# 0.05 and 7.0e-02 at 1e-4, and even at 4 layers in fp32 a round's
# aggregated deltas were up to 3.1e-01 of their largest entry apart). K12
# is held by phase 3 (every output and gradient within SCAN_KERNEL_TOL at
# this shape), by the tiny lm-rwkv round (card against CPU, deltas too)
# and by one forward's loss here
RWKV_RUN = LMRun(
    task="rwkv6-1.6b", argv=("--task", "rwkv6-1.6b") + LM_ARGV, n_params=1_584_091_136,
    insts={"wkv6_fwd_lanes_kernel<64>": 24, "wkv6_bwd_kernel<64>": 24, "wkv6_du_sum_kernel": 24},
    plain=_plain_recurrences_on_card, loss_rtol=None, forward_rtol=5e-3)
# deepseek-v2-lite-16b at 2 of its 27 layers (the dense first layer and the
# first MoE layer, both MLA): K10's forward <3, 128> (a q.k width of 192,
# three 64-column regions) and its backward <3, 2> (dK/dV on the two-
# warpgroup kernel) once a layer a client step; its first loss against the
# plain attention's as qwen3-8b's (bf16 attention outputs an ulp apart in a
# few entries, through 2 layers, the top-6 routing and a local SGD step)
DEEPSEEK_RUN = LMRun(
    task="deepseek-v2-lite-16b", argv=("--task", "deepseek-v2-lite-16b") + LM_ARGV,
    n_params=1_085_287_424,
    insts={"flash_attention_wgmma_kernel<3, 128>": 2, "fa_bwd_dkdv_split_kernel<3, 2>": 2,
           "fa_bwd_dq_wgmma_kernel<3, 2>": 2},
    plain=_plain_attention_on_card, loss_rtol=1e-3, forward_rtol=1e-3)
# zamba2-7b at 7 of its 81 layers: K13 once a Mamba2 layer, K10's forward
# <2, 112> and backward <2, 2> once an application of the shared block (2)
ZAMBA_RUN = LMRun(
    task="zamba2-7b", argv=("--task", "zamba2-7b") + LM_ARGV, n_params=980_754_096,
    insts={"ssm_scan_fwd_lanes_kernel<64, 64>": 7, "ssm_scan_bwd_kernel<64, 64>": 7,
           "ssm_scan_bc_sum_kernel": 7, "flash_attention_wgmma_kernel<2, 112>": 2,
           "fa_bwd_dkdv_wgmma_kernel<2, 2>": 2, "fa_bwd_dq_wgmma_kernel<2, 2>": 2},
    plain=_plain_kernels_on_card, loss_rtol=1e-3, forward_rtol=1e-3)


@contextlib.contextmanager
def _routing_tap(records: list):
    """Every MoE layer's top-k expert ids (B, S, k) appended to ``records``
    in call order inside the block (``models/moe.py`` routes through its
    ``_route`` by name)."""
    from repro_torch.models import moe as moe_lib

    saved = moe_lib._route

    def tapped(logits, cfg):
        out = saved(logits, cfg)
        records.append(out[2])
        return out

    moe_lib._route = tapped
    try:
        yield
    finally:
        moe_lib._route = saved


def phase_transformer_serve(torch, name: str, params: dict, corpus):
    """A trained transformer LM task (qwen3-8b, deepseek-v2-lite-16b) served
    through the model bundle on the card (``_serve_transformer``); an MoE
    model also again on an fp32 copy of its parameters (unprofiled), held
    at FP32_SERVE_TOL: its top-k routing turns a bf16 rounding into another
    expert now and then, so its bf16 logits may pass the bar with its floor
    (the recurrent serves' rule), and a token routed to other experts by
    the decode than by the teacher-forced forward is counted, not held
    (``_serve_transformer``). Returns the bf16 serve's launch counts."""
    from repro_torch.core.task import get_task

    cfg = get_task(name).config
    launches = _serve_transformer(torch, name, cfg, params, corpus, True)
    if cfg.moe is not None:
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        p32 = {k: v.float() for k, v in params.items()}
        _serve_transformer(torch, name + " fp32", cfg32, p32, corpus, False)
        del p32
        torch.cuda.empty_cache()
    return launches


def _serve_transformer(torch, name: str, cfg, params: dict, corpus, profiled: bool,
                       prompt_len: int = QWEN_PROMPT):
    """B=4 prompts of ``prompt_len`` tokens (label rows of the eval split;
    with no corpus, tokens from numpy's generator at seed 1; for a VLM
    config, seeded tokens after 576 seeded image tokens, ``_llava_batch``),
    ``prefill``, every layer group's cache copied into ``init_cache(B, n +
    32)`` (F6; n the prefix's positions: 128, 704 or gemma3's 1,152), 32
    greedy ``decode_step``s. Exact launches (K10 once a layer in
    prefill, on the tensor cores in bf16; K11 once a layer a step, none with
    MLA, whose decode scores against the compressed cache in plain einsums;
    at heads of 256 each on its wide instantiation, ``_wide_counts``),
    times and peak memory; with ``profiled``, prefill and 10 decode steps
    again under torch.profiler; every step's logits (prefill's last and the
    32 decode steps') against a teacher-forced forward over prompt and
    generated tokens (K10 once a layer; a VLM's over its image tokens too,
    through ``vlm._embed_multimodal``), the share of equal argmaxes
    printed. The logits are held at QWEN_SERVE_TOL (fp32: FP32_SERVE_TOL)
    with the greedy tokens' margin agreement; the floor, that forward again
    on the plain attention on the card, is printed beside them. With MoE
    the decode steps' forward drops no token (a decode step never does) and
    prefill's logits are held to the prompt's forward at the config's
    capacity (K10 twice a layer); the timed serve runs under
    ``_routing_tap`` (a list append a layer), and a position whose token the
    decode routes to other experts than the forward does (a rounding apart
    moves the k-th choice) is counted and printed, not held, in the floor
    as in the decode; more than MAX_REROUTED_SHARE of them fails, and a
    bf16 serve is held only where its floor stays under its bar (the
    recurrent serves' rule). That holds a model whose one MoE layer is its
    last (deepseek-v2-lite-16b at 2 layers); with an MoE layer before an
    attention layer a rerouted token, and prefill's dropped ones, would
    reach later positions through the cache, so such a model is refused
    here. Returns the serve's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model_zoo, transformer, vlm

    lm = getattr(cfg, "lm", cfg)  # a VLM's language model, else cfg itself
    if lm.moe is not None and lm.n_layers - lm.moe_first_dense != 1:
        raise ValueError(f"{name}: the serve's check holds one MoE layer, the last; this "
                         f"config has {lm.n_layers - lm.moe_first_dense}")
    import numpy as np

    bundle = model_zoo.build_model(cfg)
    if lm is not cfg:
        n_img, batch = cfg.n_img_tokens, _llava_batch(torch, cfg, (QWEN_SERVE_B,), prompt_len, 1)
    elif corpus is None:
        tokens = np.random.default_rng(1).integers(0, cfg.vocab, (QWEN_SERVE_B, prompt_len))
        n_img, batch = 0, {"tokens": torch.from_numpy(tokens).to("cuda", torch.long)}
    else:
        n_img, batch = 0, {"tokens": torch.from_numpy(
            corpus.eval_split(QWEN_SERVE_B)["labels"][:, :prompt_len]).to("cuda", torch.long)}
    L, n = lm.n_layers, n_img + prompt_len
    total = n + QWEN_STEPS
    k11 = 0 if lm.mla is not None else L  # K11 launches a decode step
    bf16 = lm.cdtype == torch.bfloat16
    route, tol = ("wgmma", QWEN_SERVE_TOL) if bf16 else ("simt", FP32_SERVE_TOL)
    D, Dv = _attn_widths(lm)
    prompt = batch["tokens"]
    tag = f"[{name} serve]"

    def serve():
        logits, cache = bundle.prefill(params, batch)
        full = bundle.init_cache(QWEN_SERVE_B, total)
        for prefix, entries in cache.items():
            for entry, t in entries.items():
                full[prefix][entry][:, :, :n].copy_(t)
        return logits, full

    def teacher_forced(tokens):
        """The logits the serve's 33 steps should give, from full forwards."""
        if lm is not cfg:
            lm_params = vlm.lm_params(params)
            x = vlm._embed_multimodal(cfg, params, {**batch, "tokens": tokens})
            h, _ = transformer.trunk(lm, lm_params, x)
            return transformer.unembed(lm, lm_params, h[:, n - 1:]).transpose(0, 1)
        if cfg.moe is None:
            h, _ = transformer.forward(cfg, params, tokens)
            return transformer.unembed(cfg, params, h[:, prompt_len - 1:]).transpose(0, 1)
        # A decode step's one token never overflows an expert (its top-k
        # experts are distinct, each of capacity >= 1), while 160 tokens at
        # the config's capacity factor drop some. So the decode steps are
        # held to a forward at a capacity of S (NO_DROP_MARGIN: no token
        # dropped), and prefill's logits to the prompt's forward at the
        # config's own capacity, the computation prefill makes.
        nodrop = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k + NO_DROP_MARGIN))
        h, _ = transformer.forward(nodrop, params, tokens)
        h0, _ = transformer.forward(cfg, params, prompt)
        return torch.cat([transformer.unembed(cfg, params, h0[:, -1:]),
                          transformer.unembed(cfg, params, h[:, prompt_len:])],
                         dim=1).transpose(0, 1)

    with torch.no_grad():
        logits, cache = serve()  # warm-up: cuBLAS handles, allocator pools
        bundle.decode_step(params, cache, logits.argmax(-1, keepdim=True), n)
        del cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_counts()
        dec_routes = []  # the timed serve's expert ids: prefill's, then each step's
        tap = _routing_tap(dec_routes) if lm.moe is not None else contextlib.nullcontext()
        with tap:
            t0 = time.perf_counter()
            logits, cache = serve()
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            _check_attn(f"{tag} prefill", {**_k10(L, route), "flash_decode": 0})
            _check_wide(f"{tag} prefill", _wide(route, D, Dv, L))
            steps, fed = [logits], []
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for i in range(QWEN_STEPS):
                fed.append(steps[-1].argmax(-1, keepdim=True))
                logits, cache = bundle.decode_step(params, cache, fed[-1], n + i)
                steps.append(logits)
            end.record()
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
        launches = {**_attn_counts(), **_wide_counts()}
        peak = torch.cuda.max_memory_allocated()
        _check_attn(f"{tag} prefill + {QWEN_STEPS} decode steps",
                    {**_k10(L, route), "flash_decode": k11 * QWEN_STEPS})
        _check_wide(f"{tag} prefill + {QWEN_STEPS} decode steps",
                    _wide(route, D, Dv, L, dec=k11 * QWEN_STEPS))
        del cache

        windows = {}
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only
                t0 = time.perf_counter()
                out, cache = serve()
                torch.cuda.synchronize()
                windows["prefill"] = (prof, prefill_s, time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(10):
                    out, cache = bundle.decode_step(params, cache, out.argmax(-1, keepdim=True),
                                                    n + i)
                torch.cuda.synchronize()
                windows["10 decode steps"] = (prof, 10 * decode_s / QWEN_STEPS,
                                              time.perf_counter() - t0)
            del cache, out
        for what, (prof, wall, wall_prof) in windows.items():
            _log_profile(tag, _device_times(torch, prof), wall, wall_prof, what=what)

        tokens = torch.cat([prompt, *fed], dim=1)                  # (B, 160)
        tf_k10 = L if lm.moe is None else 2 * L
        _zero_counts()
        tf_routes, plain_routes = [], []
        with _routing_tap(tf_routes):
            tf = teacher_forced(tokens)
        _check_attn(f"{tag} teacher-forced forward", {**_k10(tf_k10, route), "flash_decode": 0})
        _zero_counts()
        with _plain_attention_on_card(), _routing_tap(plain_routes):
            tf_plain = teacher_forced(tokens)
        _check_attn(f"{tag} teacher-forced forward on the plain attention",
                    {**_k10(0, route), "flash_decode": 0})
        dec = torch.stack(steps)                                   # (33, B, V)
        if dec.shape != tf.shape or not torch.isfinite(dec).all():
            raise AssertionError(f"{tag} decode logits {tuple(dec.shape)} are not finite or "
                                 f"not shaped as the teacher-forced {tuple(tf.shape)}")
        # (33, B): the positions whose tokens go to the same experts
        same = same_plain = torch.ones(dec.shape[:2], dtype=torch.bool, device=dec.device)
        if lm.moe is not None:
            # each position's expert set: a forward's routes are the no-drop
            # forward's (B, 160, k), then the prompt's (B, 128, k); the replayed
            # serve's its prefill's (B, 128, k), then each step's (B, 1, k)
            def alike(a, b):
                return (a.sort(-1).values == b.sort(-1).values).all(-1).transpose(0, 1)

            def at_positions(routes):
                return torch.cat([routes[1][:, -1:], routes[0][:, prompt_len:]], dim=1)

            want = at_positions(tf_routes)
            same = alike(want, torch.cat([dec_routes[0][:, -1:], *dec_routes[1:]], dim=1))
            same_plain = alike(want, at_positions(plain_routes))
        rerouted = {what: float((~m).float().mean()) for what, m in
                    (("the decode", same), ("the plain forward", same_plain))}
        if max(rerouted.values()) > MAX_REROUTED_SHARE:
            raise AssertionError(f"{tag} shares of the {same.numel()} positions routed to other "
                                 f"experts than by the teacher-forced forward: {rerouted} "
                                 f"(at most {MAX_REROUTED_SHARE})")
        top = max(float(tf.abs().max()), 1.0)
        err_all = _rel(torch, dec, tf)
        err = float((dec - tf).float()[same].abs().max()) / top
        floor = float((tf_plain - tf).float()[same_plain].abs().max()) / top
        agree = float((dec.argmax(-1) == tf.argmax(-1)).float().mean())
        # a dense model's serve is always held; a bf16 MoE serve where its floor allows
        barred = lm.moe is None or not bf16 or floor <= tol
        if barred and err > tol:
            raise AssertionError(f"{tag} decode logits against the teacher-forced forward: "
                                 f"relative error {err:.3e} > {tol} (floor {floor:.3e}) at the "
                                 f"{int(same.sum())} positions routed alike")
        checked, n_pos = _margin_agrees(torch, dec[same], tf[same], tol) if barred else \
            (0, int(same.sum()))
    log(f"{tag} B={QWEN_SERVE_B}, " + (f"{n_img} image tokens + " if n_img else "")
        + f"{prompt_len}-token prompts, {QWEN_STEPS} greedy steps: prefill over {n} positions "
        f"(with the cache copy to {total} slots) {prefill_s * 1e3:.2f} ms, decode "
        f"{decode_s * 1e3 / QWEN_STEPS:.3f} ms per token on the host clock "
        f"({start.elapsed_time(end) / QWEN_STEPS:.3f} ms between CUDA events), "
        f"{QWEN_SERVE_B * QWEN_STEPS / decode_s:.1f} tokens/s; peak memory over prefill and "
        f"decode {peak} B, {peak - held} B above the {held} B allocated before it; launches "
        f"K10 {launches['flash_attention']} (tensor cores {launches['flash_attention_wgmma']}), "
        f"K11 {launches['flash_decode']} ({k11} a step"
        + (": MLA's decode scores the compressed cache in plain einsums)"
           if lm.mla is not None else ")"))
    log(f"{tag} decode vs the teacher-forced forward over {n_img + tokens.shape[1]} positions "
        f"({tf_k10} K10 launches"
        + ("; the decode steps against a forward that drops no token, prefill's logits "
           "against the prompt's forward at the config's capacity" if lm.moe is not None
           else "")
        + f"): logits relative error {err:.3e} at the {int(same.sum())} of {same.numel()} "
        f"positions routed alike, "
        + (f"held (tol {tol})" if barred else f"NOT held: its floor passes the bar {tol}")
        + f"; {int((~same).sum())} positions routed to other experts by the decode (not held; "
        f"shares: " + ", ".join(f"{w} {r:.4f}" for w, r in rerouted.items())
        + f", at most {MAX_REROUTED_SHARE}), all positions {err_all:.3e}; floor (the same forward on the plain attention, at the "
        f"{int(same_plain.sum())} positions it routes alike) {floor:.3e}; argmax equal at "
        f"{agree:.4f} of all positions; greedy tokens agree at "
        f"{checked} of the {n_pos} positions routed alike with a clear margin")
    return launches




# llava-next-mistral-7b at full width and 4 of its 32 layers (1,155,575,808
# bf16 parameters: d_model 4,096, 32 query heads on 8 kv heads of 128, d_ff
# 14,336, vocab 32,000, Mistral's 4,096-token window in every layer, the
# projector from 576 image tokens of 1,024). Depth is the cut: a round keeps
# about 34 B a parameter on the card (qwen3-8b's 68.3 GB for 2.016 G), about
# 39 GB here before the 4,096-position activations, and about 245 GB at all
# 32 layers. Its rounds run as the reference's dry run builds them
# (make_round_step over the bundle's loss: the VLM has no federated task) on
# batches in vlm_train_batch's layout at train_4k: 576 image tokens and
# 3,520 text tokens a row, K = 4 clients of 2 local steps at b = 1, FVN
# 0.01 and the server's Adam at 1e-5 (LM_ARGV's). K10's forward <2, 128>
# and its backward <2, 2> once a layer a client step, the window passed to
# each (it masks nothing below 4,097 positions: the rows are 4,096 long).
LLAVA_LAYERS, LLAVA_PARAMS = 4, 1_155_575_808
LLAVA_ARGV = ("--clients", "4", "--batch", "1", "--fvn-std", "0.01", "--server-lr", "1e-5",
              "--rounds", "2")
LLAVA_LOCAL_STEPS = 2
LLAVA_INSTS = {"flash_attention_wgmma_kernel<2, 128>": 4, "fa_bwd_dkdv_wgmma_kernel<2, 2>": 4,
               "fa_bwd_dq_wgmma_kernel<2, 2>": 4}
# the first client step's loss at the round-start parameters, one forward on
# K10 against one on its plain version: a round on the plain attention would
# keep (32, 4,096, 512) fp32 score blocks for autograd, about 6 GB a layer
# beside the round's 39 GB, so the two are held on one forward under no_grad.
# Beside the loss, that forward's logits at all 4,096 positions (the image's
# too), relative to the largest, at QWEN_SERVE_TOL with the greedy tokens'
# margin agreement: bf16 through 4 layers, whose logits are bf16 products
# (one ulp is up to 2**-7 of an entry), where phase 3's ATTN_TOL holds one
# kernel's one rounding (the llava serve's floor, this comparison over 736
# positions, read 9.375e-03 on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6)
LLAVA_LOSS_RTOL = 1e-3


def llava_config():
    """llava-next-mistral-7b at full width and LLAVA_LAYERS of its 32
    layers (the reference's make_config takes no keywords)."""
    from repro_torch.configs import llava_next_mistral_7b

    cfg = llava_next_mistral_7b.make_config()
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, n_layers=LLAVA_LAYERS))


def _llava_batch(torch, cfg, lead: tuple, n_text: int, seed: int) -> dict:
    """Image embeddings (N(0, 1), bf16) and text tokens from numpy's
    generator at ``seed``, shaped (*lead, n_img, vit_dim) and (*lead,
    n_text), on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    img = rng.standard_normal(lead + (cfg.n_img_tokens, cfg.vit_dim), dtype=np.float32)
    tokens = rng.integers(0, cfg.lm.vocab, lead + (n_text,), dtype=np.int32)
    return {"image_embeds": torch.from_numpy(img).to("cuda", cfg.cdtype),
            "tokens": torch.from_numpy(tokens).to("cuda")}


def phase_vlm_train(torch):
    """llava-next-mistral-7b trained at full width (``llava_config``): two
    FedAvg rounds through ``make_round_step(bundle.loss_fn, plan, seed)``
    with the training entry point's plan (LLAVA_ARGV) on a round batch in
    ``vlm_train_batch``'s layout at train_4k (4,096 positions a row), exact
    launches a client step, round times, peak memory; one more round under
    torch.profiler (``_profiled_round``: device time by kernel, busy share,
    LLAVA_INSTS); the
    first client step's loss at the round-start parameters on K10 and on
    its plain version on the card, one forward each, within
    LLAVA_LOSS_RTOL, and its logits at every position within
    QWEN_SERVE_TOL of the largest. Returns (the training rounds' launch
    counts, the trained parameters)."""
    from repro_torch.configs import base
    from repro_torch.core.fedavg import init_server_state, make_round_step
    from repro_torch.launch import train
    from repro_torch.models import model_zoo, transformer, vlm

    cfg, tag = llava_config(), "[llava-next-mistral-7b train]"
    args = train.parse_args(list(LLAVA_ARGV))
    plan, rounds = train.build_plan(args), args.rounds
    layout = base.vlm_train_batch(base.SHAPES["train_4k"], args.clients, LLAVA_LOCAL_STEPS,
                                  args.batch, cfg)
    batch = _llava_batch(torch, cfg, tuple(layout["tokens"].shape[:3]),
                         layout["tokens"].shape[3], 0)
    batch["weight"] = torch.ones(layout["weight"].shape, device="cuda")
    if {k: (v.shape, v.dtype) for k, v in batch.items()} != \
            {k: (v.shape, v.dtype) for k, v in layout.items()}:
        raise AssertionError(f"{tag} the batch is not vlm_train_batch's layout")
    bundle = model_zoo.build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = bundle.param_count(params)
    if n_params != LLAVA_PARAMS:
        raise AssertionError(f"{tag} {n_params} parameters, expected {LLAVA_PARAMS}")
    step = make_round_step(bundle.loss_fn, plan, 0)
    first = {k: v[0, 0] for k, v in batch.items()}

    def forward():
        """The loss through the bundle, and the logits at every position."""
        lm_params = vlm.lm_params(params)
        h, _ = transformer.trunk(cfg.lm, lm_params, vlm._embed_multimodal(cfg, params, first))
        return float(bundle.loss_fn(params, first)[0]), transformer.unembed(cfg.lm, lm_params, h)

    with torch.no_grad():
        _zero_counts()
        loss_k, logits_k = forward()
        _check_attn(f"{tag} one forward", {**_k10(2 * LLAVA_LAYERS), "flash_decode": 0})
        with _plain_attention_on_card():
            loss_p, logits_p = forward()
        _check_attn(f"{tag} one forward on the plain attention",
                    {**_k10(2 * LLAVA_LAYERS), "flash_decode": 0})
        rel = abs(loss_k - loss_p) / abs(loss_p)
        logits_rel = _rel(torch, logits_k, logits_p)
        if not math.isfinite(loss_k) or rel > LLAVA_LOSS_RTOL or \
                not torch.isfinite(logits_k).all() or logits_rel > QWEN_SERVE_TOL:
            raise AssertionError(f"{tag} the first client step's forward on K10 against the "
                                 f"plain attention's: loss {loss_k} against {loss_p}, relative "
                                 f"gap {rel:.3e} (tol {LLAVA_LOSS_RTOL}); logits relative error "
                                 f"{logits_rel:.3e} (tol {QWEN_SERVE_TOL})")
        checked, n_pos = _margin_agrees(torch, logits_k, logits_p, QWEN_SERVE_TOL)
        del logits_k, logits_p
    state = init_server_state(plan, params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_counts()
    losses, round_s = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    peak = torch.cuda.max_memory_allocated()
    trained = _counts()
    steps = args.clients * LLAVA_LOCAL_STEPS * rounds
    want = {k: 0 for k in trained}
    want.update(_k10(LLAVA_LAYERS * steps, bwd=LLAVA_LAYERS * steps), threefry_normal=steps)
    if trained != want:
        raise AssertionError(f"{tag} launches over the training rounds "
                             f"{ {k: v for k, v in trained.items() if v} }, expected "
                             f"{ {k: v for k, v in want.items() if v} } ({steps} client steps)")
    if not all(math.isfinite(x) for x in losses) or metrics["examples"] != \
            args.clients * LLAVA_LOCAL_STEPS * args.batch:
        raise AssertionError(f"{tag} losses {losses}, examples {metrics['examples']}")
    def profiled():
        nonlocal state
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    want_round = {k: 0 for k in trained}
    want_round.update({k: v // rounds for k, v in want.items()})
    _profiled_round(torch, tag, profiled, round_s[-1], LLAVA_INSTS, steps // rounds, want_round)
    params = {k: v.detach() for k, v in state.params.items()}
    del state
    log(f"{tag} {n_params} parameters ({cfg.lm.pdtype}) in {len(params)} leaves, "
        f"{LLAVA_LAYERS} of 32 layers; K={args.clients} b={args.batch} {LLAVA_LOCAL_STEPS} "
        f"local steps over rows of {cfg.n_img_tokens} image + {layout['tokens'].shape[3]} text "
        f"tokens, FVN {args.fvn_std}: losses {losses}; ms per round "
        f"{[round(t * 1e3, 1) for t in round_s]}; client examples per second "
        f"{[args.clients * LLAVA_LOCAL_STEPS * args.batch / t for t in round_s]}; peak memory "
        f"over the training rounds {peak} B ({held} B allocated before them)")
    log(f"{tag} launches per client step over {steps} client steps: "
        + ", ".join(f"{k} {v / steps:g}" for k, v in trained.items() if v))
    log(f"{tag} the first client step's loss at the round-start parameters, one forward: "
        f"{loss_k} on K10, {loss_p} on its plain version on the card: relative gap "
        f"{rel:.3e} (tol {LLAVA_LOSS_RTOL}); its logits at all {cfg.n_img_tokens} + "
        f"{first['tokens'].shape[-1]} positions: relative error {logits_rel:.3e} (tol "
        f"{QWEN_SERVE_TOL}), greedy tokens agree at {checked} of the {n_pos} positions with a "
        f"clear margin")
    return trained, params


# gemma3-4b at full width and 6 of its 34 layers (1,908,444,672 bf16
# parameters: d_model 2,560, 8 query heads on 4 kv heads of 256, d_ff 10,240,
# vocab 262,144 (the embedding and the unembedding 1,342,177,280 of them),
# qk_norm, (1 + scale) RMSNorm, sqrt(2,560) = 50.5 in bf16 on the
# embeddings; 5 local layers of a 1,024-token window to 1 global). Depth is
# the cut: 6 layers is the least that holds one global layer, so it holds
# the model's pattern. Reckoned before the first run: at llava's 31 B and
# qwen3-8b's 34 B a parameter a round keeps 59-65 GB, the loss's fp32
# logits kept for autograd 4.3 GB (32 chunks of 128 rows x 262,144) and the
# activations of 6 layers at 4,096 positions about 3 GB: 66-72 GB of the
# card's 80, so the rows stay at train_4k's 4,096 (all 34 layers would need
# 141-155 GB). Measured on an H100 80GB, right after qwen3-8b's phases: a
# peak of 61,347,118,592 B (32 B a parameter), 23,670,374,912 B of the
# card's 85,017,493,504 to spare, so the phase runs on the allocator
# qwen3-8b released; the phase prints its headroom. Its rounds run as llava's (``make_round_step`` over the
# bundle's loss, as the reference's dry run) on a round batch in
# ``lm_train_batch``'s layout at train_4k: K = 4 clients of 2 local steps at b
# = 1, tokens from numpy's generator over the whole vocabulary, FVN 0.01 and
# the server's Adam at 1e-5 (LLAVA_ARGV). A client step launches K10's
# forward 6 times (5 with the window, which masks keys from position 1,024
# on, 1 without) and its backward 6, all on the wide instantiations.
GEMMA3_LAYERS, GEMMA3_PARAMS = 6, 1_908_444_672
GEMMA3_LOCAL_STEPS = 2
GEMMA3_INSTS = {"flash_attention_wgmma_wide_kernel<4, 128>": 6, "fa_bwd_prep_kernel": 6,
                "fa_bwd_dkdv_halves_kernel<4, 4>": 6, "fa_bwd_dq_halves_kernel<4, 4>": 6}
# the first client step's loss at the round-start parameters, one forward on
# K10 against one on its plain version under no_grad (a round on the plain
# attention would keep (8, 4,096, 512) fp32 score blocks a layer), as
# llava's; its logits at all 4,096 positions at QWEN_SERVE_TOL with the
# greedy tokens' margin agreement
GEMMA3_LOSS_RTOL = 1e-3
# the serve: B = 4 prompts of 1,152 seeded tokens (past the window of 1,024,
# so the local layers' K10 in prefill and K11 in every decode step mask
# keys), the cache grown to 1,184 slots
GEMMA3_PROMPT = 1152


def gemma3_config():
    """gemma3-4b at full width and GEMMA3_LAYERS of its 34 layers."""
    from repro_torch.configs import gemma3_4b

    return gemma3_4b.make_config(n_layers=GEMMA3_LAYERS)


def _window_tap(records: list):
    """Each K10 call the models make inside the block appends its window
    (0: none) to ``records``; its launches and results unchanged."""
    from repro_torch.models import attention

    saved = attention.flash_attention

    def tapped(q, k, v, **kw):
        records.append(int(kw.get("window") or 0))
        return saved(q, k, v, **kw)

    return _attention_swapped(tapped)


def phase_gemma3_train(torch):
    """gemma3-4b trained at full width (``gemma3_config``): two FedAvg rounds
    through ``make_round_step(bundle.loss_fn, plan, seed)`` with the
    training entry point's plan (LLAVA_ARGV) on a round batch in
    ``lm_train_batch``'s layout at train_4k, exact launches a client step
    (K10's forward and backward 6 each on the wide instantiations, the
    normal kernel 1), round times, peak memory; one more round under
    torch.profiler (``_profiled_round``: device time by kernel, busy share,
    GEMMA3_INSTS); the first client step's forward on K10 and on its plain
    version on the card, the windows of its 12 K10 calls (5 local and 1
    global layer, in the trunk and in the loss), its loss within
    GEMMA3_LOSS_RTOL and its logits at every position within QWEN_SERVE_TOL
    of the largest. Returns (the training rounds' launch counts, the
    trained parameters)."""
    import numpy as np

    from repro_torch.configs import base
    from repro_torch.core.fedavg import init_server_state, make_round_step
    from repro_torch.launch import train
    from repro_torch.models import model_zoo, transformer

    cfg, tag = gemma3_config(), "[gemma3-4b train]"
    L = cfg.n_layers
    args = train.parse_args(list(LLAVA_ARGV))
    plan, rounds = train.build_plan(args), args.rounds
    layout = base.lm_train_batch(base.SHAPES["train_4k"], args.clients, GEMMA3_LOCAL_STEPS,
                                 args.batch)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, tuple(layout["tokens"].shape),
                                               dtype=np.int32)
    batch = {"tokens": torch.from_numpy(tokens).to("cuda"),
             "weight": torch.ones(layout["weight"].shape, device="cuda")}
    if {k: (v.shape, v.dtype) for k, v in batch.items()} != \
            {k: (v.shape, v.dtype) for k, v in layout.items()}:
        raise AssertionError(f"{tag} the batch is not lm_train_batch's layout")
    bundle = model_zoo.build_model(cfg)
    params = bundle.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = bundle.param_count(params)
    if n_params != GEMMA3_PARAMS:
        raise AssertionError(f"{tag} {n_params} parameters, expected {GEMMA3_PARAMS}")
    step = make_round_step(bundle.loss_fn, plan, 0)
    first = {k: v[0, 0] for k, v in batch.items()}

    def forward():
        """The loss through the bundle, and the logits at every position."""
        h, _ = transformer.forward(cfg, params, first["tokens"])
        return float(bundle.loss_fn(params, first)[0]), transformer.unembed(cfg, params, h)

    with torch.no_grad():
        _zero_counts()
        windows = []
        with _window_tap(windows):
            loss_k, logits_k = forward()
        _check_attn(f"{tag} one forward", {**_k10(2 * L), "flash_decode": 0})
        _check_wide(f"{tag} one forward", _wide("wgmma", cfg.head_dim, cfg.head_dim, 2 * L))
        if windows != cfg.layer_windows() * 2:
            raise AssertionError(f"{tag} the forward's K10 windows {windows}, expected "
                                 f"{cfg.layer_windows()} in the trunk and in the loss")
        with _plain_attention_on_card():
            loss_p, logits_p = forward()
        _check_attn(f"{tag} one forward on the plain attention",
                    {**_k10(2 * L), "flash_decode": 0})
        rel = abs(loss_k - loss_p) / abs(loss_p)
        logits_rel = _rel(torch, logits_k, logits_p)
        if not math.isfinite(loss_k) or rel > GEMMA3_LOSS_RTOL or \
                not torch.isfinite(logits_k).all() or logits_rel > QWEN_SERVE_TOL:
            raise AssertionError(f"{tag} the first client step's forward on K10 against the "
                                 f"plain attention's: loss {loss_k} against {loss_p}, relative "
                                 f"gap {rel:.3e} (tol {GEMMA3_LOSS_RTOL}); logits relative "
                                 f"error {logits_rel:.3e} (tol {QWEN_SERVE_TOL})")
        checked, n_pos = _margin_agrees(torch, logits_k, logits_p, QWEN_SERVE_TOL)
        del logits_k, logits_p
    state = init_server_state(plan, params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _zero_counts()
    losses, round_s = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"])
    peak = torch.cuda.max_memory_allocated()
    trained = _counts()
    steps = args.clients * GEMMA3_LOCAL_STEPS * rounds
    want = {k: 0 for k in trained}
    want.update(_k10(L * steps, bwd=L * steps), threefry_normal=steps)
    want.update(_wide("wgmma", cfg.head_dim, cfg.head_dim, L * steps, bwd=L * steps))
    if trained != want:
        raise AssertionError(f"{tag} launches over the training rounds "
                             f"{ {k: v for k, v in trained.items() if v} }, expected "
                             f"{ {k: v for k, v in want.items() if v} } ({steps} client steps)")
    if not all(math.isfinite(x) for x in losses) or metrics["examples"] != \
            args.clients * GEMMA3_LOCAL_STEPS * args.batch:
        raise AssertionError(f"{tag} losses {losses}, examples {metrics['examples']}")

    def profiled():
        nonlocal state
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    want_round = {k: v // rounds for k, v in want.items()}
    _profiled_round(torch, tag, profiled, round_s[-1], GEMMA3_INSTS, steps // rounds, want_round)
    params = {k: v.detach() for k, v in state.params.items()}
    del state
    log(f"{tag} {n_params} parameters ({cfg.pdtype}) in {len(params)} leaves, {L} of 34 "
        f"layers (windows {cfg.layer_windows()}); K={args.clients} b={args.batch} "
        f"{GEMMA3_LOCAL_STEPS} local steps over rows of {layout['tokens'].shape[3]} tokens, FVN "
        f"{args.fvn_std}: losses {losses}; ms per round {[round(t * 1e3, 1) for t in round_s]}; "
        f"client examples per second "
        f"{[args.clients * GEMMA3_LOCAL_STEPS * args.batch / t for t in round_s]}; peak memory "
        f"over the training rounds {peak} B ({held} B allocated before them; "
        f"{torch.cuda.get_device_properties(0).total_memory - peak} B of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory} B to spare)")
    log(f"{tag} launches per client step over {steps} client steps: "
        + ", ".join(f"{k} {v / steps:g}" for k, v in trained.items() if v)
        + " (K10's forward 5 with the window of 1,024 and 1 without, by the forward's calls)")
    log(f"{tag} the first client step's loss at the round-start parameters, one forward: "
        f"{loss_k} on K10, {loss_p} on its plain version on the card: relative gap "
        f"{rel:.3e} (tol {GEMMA3_LOSS_RTOL}); its logits at all {first['tokens'].shape[-1]} "
        f"positions: relative error {logits_rel:.3e} (tol {QWEN_SERVE_TOL}), greedy tokens "
        f"agree at {checked} of the {n_pos} positions with a clear margin")
    return trained, params


# the registry phase: each assigned arch's smoke config served through the
# serve_lm twin (examples/serve_lm.py's): a REGISTRY_PROMPT-token prompt
# decoded token by token, then REGISTRY_TOKENS greedy steps, B =
# REGISTRY_B, fp32, on the card and on the CPU
REGISTRY_B, REGISTRY_PROMPT, REGISTRY_TOKENS = 4, 4, 8
REGISTRY_ARGV = ("--batch", str(REGISTRY_B), "--prompt-len", str(REGISTRY_PROMPT),
                 "--tokens", str(REGISTRY_TOKENS))


def phase_registry_serves(torch) -> dict:
    """Every assigned architecture of the ``--arch`` registry (not
    rnnt-librispeech: no serve step) served at its smoke config through
    ``repro_torch.examples.serve_lm`` on the card, its counts set to 0 just
    before and read just after: the decode steps' K11 launches (once a
    self-attention layer a step; whisper's cross-attention too; none with
    MLA), K12's or K13's (once a recurrent layer a step); then the same
    serve with ``--device cpu`` (the same seeded parameters and prompt, the
    plain versions): the greedy token ids identical and every step's
    logits within TINY_SERVE_TOL's fp32 bar of the CPU's largest. Returns
    the launch counts summed over the serves, each added once its serve
    has agreed with the CPU's."""
    from repro_torch.configs import get_arch, registry
    from repro_torch.examples import serve_lm

    steps, tol = REGISTRY_PROMPT + REGISTRY_TOKENS, TINY_SERVE_TOL["float32"]
    summed: dict = {}
    for arch_id in registry.ASSIGNED:
        arch, tag = get_arch(arch_id), f"[registry {arch_id} serve]"
        cfg = arch.make_smoke_config()
        lm = getattr(cfg, "lm", cfg)
        want = {}
        if arch.kind in ("dense", "moe", "vlm"):
            want["flash_decode"] = 0 if lm.mla is not None else lm.n_layers * steps
        elif arch.kind == "audio":
            want["flash_decode"] = 2 * cfg.dec_layers * steps
        elif arch.kind == "ssm":
            want["wkv6_fwd"] = cfg.n_layers * steps
        elif arch.kind == "hybrid":
            want.update(ssm_scan_fwd=cfg.n_layers * steps,
                        flash_decode=cfg.n_attn_applications * steps)
        _zero_counts()
        out = serve_lm.main(["--arch", arch_id, *REGISTRY_ARGV])
        torch.cuda.synchronize()
        counts = {k: v for k, v in _counts().items() if v}
        expected = {k: v for k, v in want.items() if v}
        if counts != expected:
            raise AssertionError(f"{tag} launches {counts}, expected {expected}")
        ref = serve_lm.main(["--arch", arch_id, *REGISTRY_ARGV, "--device", "cpu"])
        if out["logits"].shape != ref["logits"].shape or not torch.isfinite(out["logits"]).all():
            raise AssertionError(f"{tag} logits {tuple(out['logits'].shape)} are not finite or "
                                 f"not shaped as the CPU's {tuple(ref['logits'].shape)}")
        same = bool((out["tokens"] == ref["tokens"]).all())
        err = _rel(torch, out["logits"], ref["logits"])
        if not same or err > tol:
            raise AssertionError(f"{tag} against the CPU's serve: token ids "
                                 f"{'identical' if same else 'differ'}, logits relative error "
                                 f"{err:.3e} (tol {tol})")
        for k, v in counts.items():
            summed[k] = summed.get(k, 0) + v
        log(f"{tag} {arch.kind}, {out['n_params']} parameters (smoke, fp32): {steps} decode "
            f"steps at B={REGISTRY_B} in {(out['prefill_s'] + out['decode_s']) * 1e3:.1f} ms on "
            f"the host clock; launches "
            f"{counts or 'none (its decode runs no hand-written kernel)'}; against the CPU's "
            f"serve: token ids identical, the {steps} steps' logits relative error {err:.3e} "
            f"(tol {tol})")
    return summed


# the recurrent serves' logits against the teacher-forced forward, relative
# to the largest logit: bf16 at the qwen serve's bar, fp32 copies of the
# parameters at FP32_SERVE_TOL (the same decode, sums in fp32). Each serve
# also measures its floor: the same teacher-forced forward on the plain
# versions of its kernels on the card, whose fp32 sums differ from the
# kernels' in order alone. A bf16 serve whose floor passes the bar is
# printed and not held: no bar below the floor tells a right decode from
# a wrong one. rwkv6-1.6b's bf16 serve is such a one (24 layers turn the
# fp32 sums' 1e-7 into a floor of 1.474e-01 at init, an NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md §7); its fp32 serve holds the decode path.
FP32_SERVE_TOL = 1e-2


def phase_recurrent_serve(torch, name: str, params: dict, corpus):
    """A trained recurrent LM served through the model bundle on the card,
    B=4 prompts of 128 tokens (label rows of the eval split), 32 greedy
    steps, then again on an fp32 copy of the parameters (unprofiled).
    rwkv6-1.6b: ``prefill`` (its state after the prompt; K12 once a
    layer) then 32 ``decode_step``s (K12 once a layer each). zamba2-7b has no
    prefill (the reference's): 160 ``decode_step``s from ``init_cache(4,
    160)``, the prompt's 128 teacher-fed, then 32 greedy (K13 once a Mamba2
    layer and K11 once an application of the shared block a step). Exact
    launches, times and peak memory; the prompt and 10 decode steps again
    under torch.profiler; every step's logits (rwkv: prefill's last and the
    32 decode steps'; zamba2: all 160) held to a teacher-forced forward over
    prompt and generated tokens at QWEN_SERVE_TOL (fp32: FP32_SERVE_TOL;
    a bf16 serve whose floor passes its bar is printed, not held), the
    share of equal argmaxes printed. Returns the serve's launch counts (the
    bf16 serve's)."""
    from repro_torch.core.task import get_task

    cfg = get_task(name).config
    launches = _serve_recurrent(torch, name, cfg, params, corpus, QWEN_SERVE_TOL, True)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    p32 = {k: v.float() for k, v in params.items()}
    _serve_recurrent(torch, name + " fp32", cfg32, p32, corpus, FP32_SERVE_TOL, False)
    del p32
    torch.cuda.empty_cache()
    return launches


def _serve_recurrent(torch, name: str, cfg, params: dict, corpus, tol: float,
                     profiled: bool) -> dict:
    """One serve of ``phase_recurrent_serve``; ``profiled``: the prompt and
    10 decode steps again under torch.profiler. The logits are held at
    ``tol`` unless the serve is bf16 and its floor (the teacher-forced
    forward on the plain versions against it) passes ``tol``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import hybrid, model_zoo

    bundle = model_zoo.build_model(cfg)
    B, P_LEN, STEPS = QWEN_SERVE_B, QWEN_PROMPT, QWEN_STEPS
    total = P_LEN + STEPS
    prompt = torch.from_numpy(corpus.eval_split(B)["labels"][:, :P_LEN]).to("cuda", torch.long)
    tag = f"[{name} serve]"
    rwkv = bundle.kind == "ssm"
    if rwkv:
        per_step = {"wkv6_fwd": cfg.n_layers}
        per_prompt = {"wkv6_fwd": cfg.n_layers}
    else:
        per_step = {"ssm_scan_fwd": cfg.n_layers, "flash_decode": cfg.n_attn_applications}
        per_prompt = {k: v * P_LEN for k, v in per_step.items()}

    def run_prompt():
        """(logits after each fed prompt position that is checked, state)."""
        if rwkv:
            logits, state = bundle.prefill(params, {"tokens": prompt})
            return [logits], state
        cache, out = bundle.init_cache(B, total), []
        for t in range(P_LEN):
            logits, cache = bundle.decode_step(params, cache, prompt[:, t:t + 1], t)
            out.append(logits)
        return out, cache

    def expect(what: str, want: dict) -> None:
        got = _counts()
        full = {k: 0 for k in got}
        full.update(want)
        if got != full:
            raise AssertionError(f"{tag} {what}: launches "
                                 f"{ {k: v for k, v in got.items() if v} }, expected "
                                 f"{ {k: v for k, v in full.items() if v} }")

    with torch.no_grad():
        logits, state = run_prompt()  # warm-up: cuBLAS handles, allocator pools
        bundle.decode_step(params, state, logits[-1].argmax(-1, keepdim=True), P_LEN)
        del state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _zero_counts()
        t0 = time.perf_counter()
        steps, state = run_prompt()
        torch.cuda.synchronize()
        prompt_s = time.perf_counter() - t0
        expect("the prompt", per_prompt)
        fed = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(STEPS):
            fed.append(steps[-1].argmax(-1, keepdim=True))
            logits, state = bundle.decode_step(params, state, fed[-1], P_LEN + i)
            steps.append(logits)
        end.record()
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
        expect(f"the prompt + {STEPS} decode steps",
               {k: per_prompt.get(k, 0) + v * STEPS for k, v in per_step.items()})
        del state

        windows = {}
        if profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:  # device events only
                t0 = time.perf_counter()
                out, state = run_prompt()
                torch.cuda.synchronize()
                windows["prompt"] = (prof, prompt_s, time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = out[-1]
                for i in range(10):
                    out, state = bundle.decode_step(params, state,
                                                    out.argmax(-1, keepdim=True), P_LEN + i)
                torch.cuda.synchronize()
                windows["10 decode steps"] = (prof, 10 * decode_s / STEPS,
                                              time.perf_counter() - t0)
            del state, out
        for what, (prof, wall, wall_prof) in windows.items():
            by_name = _device_times(torch, prof)
            _log_profile(tag, by_name, wall, wall_prof, what=what)
            kname = "wkv6_fwd" if rwkv else "ssm_scan_fwd"
            us, n = (sum(v[i] for k, v in by_name.items() if kname in k) for i in (0, 1))
            log(f"{tag} {'K12' if rwkv else 'K13'}'s forward in the profiled {what}: "
                f"{us:.1f} us of device time in {n} launches"
                + (f", {us / n:.2f} us a launch" if n else ""))

        tokens = torch.cat([prompt, *fed], dim=1)                  # (B, 160)
        _zero_counts()
        if rwkv:
            h, _ = model_zoo._rwkv_forward(cfg, params, tokens)
            expect("teacher-forced forward", {"wkv6_fwd": cfg.n_layers})
            h = h[:, P_LEN - 1:]
        else:
            h = hybrid.forward(cfg, params, tokens)
            route = "wgmma" if cfg.cdtype == torch.bfloat16 else "simt"
            expect("teacher-forced forward", {**_k10(cfg.n_attn_applications, route),
                                              "ssm_scan_fwd": cfg.n_layers})
        tf = (h @ params["unembed"].to(cfg.cdtype)).float().transpose(0, 1)
        _zero_counts()
        with _plain_kernels_on_card():
            h = model_zoo._rwkv_forward(cfg, params, tokens)[0][:, P_LEN - 1:] if rwkv else \
                hybrid.forward(cfg, params, tokens)
        expect("teacher-forced forward on the plain versions", {})
        floor = _rel(torch, (h @ params["unembed"].to(cfg.cdtype)).float().transpose(0, 1), tf)
        del h
        dec = torch.stack(steps)                                   # (positions, B, V)
        if dec.shape != tf.shape or not torch.isfinite(dec).all():
            raise AssertionError(f"{tag} decode logits {tuple(dec.shape)} are not finite or "
                                 f"not shaped as the teacher-forced {tuple(tf.shape)}")
        err = _rel(torch, dec, tf)
        same = float((dec.argmax(-1) == tf.argmax(-1)).float().mean())
        barred = cfg.cdtype == torch.float32 or floor <= tol
        if barred and err > tol:
            raise AssertionError(f"{tag} decode logits against the teacher-forced forward: "
                                 f"relative error {err:.3e} > {tol} (floor {floor:.3e})")
        checked = _margin_agrees(torch, dec, tf, tol)[0] if barred else 0
    how = "prefill" if rwkv else f"{P_LEN} teacher-fed decode steps"
    log(f"{tag} B={B}, {P_LEN}-token prompts ({how}), {STEPS} greedy steps: the prompt "
        f"{prompt_s * 1e3:.2f} ms, decode {decode_s * 1e3 / STEPS:.3f} ms per token on the host "
        f"clock ({start.elapsed_time(end) / STEPS:.3f} ms between CUDA events), "
        f"{B * STEPS / decode_s:.1f} tokens/s; peak memory over the serve {peak} B, "
        f"{peak - held} B above the {held} B allocated before it; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
        + " (a step: " + ", ".join(f"{k} {v}" for k, v in per_step.items()) + ")")
    n_pos = dec.shape[0] * dec.shape[1]
    log(f"{tag} decode vs the teacher-forced forward over {tokens.shape[1]} tokens: logits "
        f"relative error {err:.3e} at {dec.shape[0]} positions, "
        + (f"held (tol {tol})" if barred else f"NOT held: its floor passes the bar {tol}")
        + f"; floor (the same forward on the plain versions of the kernels) {floor:.3e}; "
        f"argmax equal at {same:.4f} of the {n_pos} positions"
        + (f"; greedy tokens agree at {checked} of {n_pos} positions with a clear margin"
           if barred else ""))
    return launches


# K12 and K13: the fewest fp32 operations a state entry a step that the
# function needs (a fused multiply-add as 2), whatever the design. K12's
# forward: r·S into y (2), the update w S + k v (3); the bonus term
# v_j (Σ_i r_i u_i k_i) is a vector's work, not an entry's. Its backward:
# S_{t-1} again from S_0 (3: no stored states are read), the sums into
# dr, dk, dw and dv (2 each) and the state cotangent's a G + r dy (3).
# K13's forward: a h + (dt x) B (3), its sum with C into y (2); its
# backward: h_{t-1} again (3), the sums into dC, dB, d(dt x) and da (2
# each) and G's a G + dy C (3).
WKV6_FWD_FLOPS, WKV6_BWD_FLOPS = 5, 14
SSM_FWD_FLOPS, SSM_BWD_FLOPS = 5, 14
# K12's and K13's kernels against their plain versions (same products,
# sums in another order over up to 129 steps), relative to the largest
# entry of each output
SCAN_KERNEL_TOL = 2e-6
# the main paths' shapes (B, S, H, P[, N]): rwkv6-1.6b's time mix (B=4
# rows of 128 tokens, 32 heads of 64) and its decode step from a state;
# zamba2-7b's Mamba2 layers (112 heads of 64, state 64) and its decode step;
# ragged and small shapes (the tiny tasks' head sizes, S past two chunks)
WKV6_SHAPES = (("rwkv6-1.6b train", 4, 128, 32, 64, False),
               ("rwkv6-1.6b decode step", 4, 1, 32, 64, True),
               ("ragged", 3, 129, 4, 32, True), ("lm-rwkv", 4, 12, 2, 16, False))
SSM_SHAPES = (("zamba2-7b train", 4, 128, 112, 64, 64, False),
              ("zamba2-7b decode step", 4, 1, 112, 64, 64, True),
              ("ragged", 3, 129, 5, 32, 16, True), ("zamba2 smoke", 4, 12, 8, 32, 16, False))


def _scan_inputs(torch, gen, kind: str, B, S, H, P, N, from_state):
    """Inputs drawn as the models give them: K12's decays exp(-exp(w0 +
    lora)) near rwkv's init (w0 = -6), K13's dt a softplus near 0.05 and
    its decays exp(dt A) with A from -1 to -16."""
    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if kind == "wkv6":
        ins = [rn(B, S, H, P) * 0.5 for _ in range(3)]
        ins.append(torch.exp(-torch.exp(-6.0 + 2.0 * rn(B, S, H, P))))
        ins.append(rn(H, P) * 0.1)
        state = rn(B, H, P, P) * 0.1 if from_state else None
        return ins, state, rn(B, S, H, P), rn(B, H, P, P) * 0.1 if from_state else None
    dt = torch.nn.functional.softplus(rn(B, S, H) * 0.5 + math.log(math.expm1(0.05)))
    a = torch.exp(dt * -torch.linspace(1.0, 16.0, H, device="cuda"))
    ins = [rn(B, S, H, P), dt, a, rn(B, S, N), rn(B, S, N)]
    state = rn(B, H, P, N) * 0.1 if from_state else None
    return ins, state, rn(B, S, H, P), rn(B, H, P, N) * 0.1 if from_state else None


def phase_recurrence_kernels(torch):
    """K12 (WKV-6) and K13 (Mamba2's scan), forward and backward, against
    their plain versions on the card at WKV6_SHAPES and SSM_SHAPES (the
    full-size training shapes and decode steps from a state, a ragged
    length past two checkpoint chunks, the tiny tasks' widths): every
    output (the checkpoints too) within SCAN_KERNEL_TOL, each call twice
    for the same bits, one launch counted a call; timed eager and from a
    CUDA graph beside the plain version and the bound (a forward as the
    path calls it: with checkpoints where S > 1, as training does, none at
    a decode step, as the serves do), each kernel's block printed. No
    single PyTorch call computes either recurrence: no library yardstick.
    Returns {kernel: row} at the training shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as K13
    from repro_torch.kernels import wkv6 as K12

    gen = torch.Generator(device="cuda").manual_seed(29)
    rows = {}
    for kind, shapes in (("wkv6", WKV6_SHAPES), ("ssm_scan", SSM_SHAPES)):
        K = K12 if kind == "wkv6" else K13
        fwd_ref, bwd_ref = (ref.wkv6_fwd_ref, ref.wkv6_bwd_ref) if kind == "wkv6" else \
            (ref.ssm_scan_fwd_ref, ref.ssm_scan_bwd_ref)
        fwd, bwd = (K12.wkv6_fwd, K12.wkv6_bwd) if kind == "wkv6" else \
            (K13.ssm_scan_fwd, K13.ssm_scan_bwd)
        for spec in shapes:
            name, B, S, H, P = spec[:5]
            N = P if kind == "wkv6" else spec[5]
            ins, state, dy, dstate = _scan_inputs(torch, gen, kind, B, S, H, P, N, spec[-1])
            tag = f"{kind} {name} (B={B} S={S} H={H} P={P}" + \
                ("" if kind == "wkv6" else f" N={N}") + ")"
            before = (K.FWD_LAUNCHES, K.BWD_LAUNCHES)
            out = fwd(*ins, state, checkpoints=True)
            grads = bwd(*ins, out[2], dy, dstate)
            torch.cuda.synchronize()
            if (K.FWD_LAUNCHES - before[0], K.BWD_LAUNCHES - before[1]) != (1, 1):
                raise AssertionError(f"{tag}: launch counts moved "
                                     f"{(K.FWD_LAUNCHES - before[0], K.BWD_LAUNCHES - before[1])}")
            want = fwd_ref(*ins, state, K.CHUNK)
            want_g = bwd_ref(*ins, want[2], dy, dstate, K.CHUNK)
            errs = [_rel(torch, g, w) for g, w in zip(out + grads, want + want_g)]
            if max(errs) > SCAN_KERNEL_TOL or any(g.shape != w.shape for g, w in
                                                  zip(out + grads, want + want_g)):
                raise AssertionError(f"{tag}: relative errors {errs} (tol {SCAN_KERNEL_TOL})")
            again = fwd(*ins, state, checkpoints=True) + bwd(*ins, out[2], dy, dstate)
            if not all(torch.equal(a, g) for a, g in zip(again, out + grads)):
                raise AssertionError(f"{tag}: a second call gave other bits")
            # the bound: each input read once and each output (y and S_T; the
            # gradients) written once, no checkpoint (the design's own traffic),
            # and the function's fp32 operations
            f_flops, b_flops = (WKV6_FWD_FLOPS, WKV6_BWD_FLOPS) if kind == "wkv6" else \
                (SSM_FWD_FLOPS, SSM_BWD_FLOPS)
            entries = B * S * H * P * N
            nbytes_in = 4 * sum(t.numel() for t in ins) + (0 if state is None else
                                                           4 * state.numel())
            f_bytes = nbytes_in + 4 * sum(t.numel() for t in out[:2])
            b_bytes = nbytes_in + 4 * dy.numel() + \
                (0 if dstate is None else 4 * dstate.numel()) + 4 * sum(g.numel() for g in grads)
            f_bound, f_by = _bound(f_bytes, f_flops * entries)
            b_bound, b_by = _bound(b_bytes, b_flops * entries)
            n = 20 if S > 1 else 100
            plain_n = 2 if S > 1 else 10
            ck = S > 1
            times = {
                "forward": (cuda_ms(torch, lambda: fwd(*ins, state, checkpoints=ck), n),
                            graph_ms(torch, lambda: fwd(*ins, state, checkpoints=ck), n),
                            cuda_ms(torch, lambda: fwd_ref(*ins, state, K.CHUNK), plain_n)),
                "backward": (cuda_ms(torch, lambda: bwd(*ins, out[2], dy, dstate), n),
                             graph_ms(torch, lambda: bwd(*ins, out[2], dy, dstate), n),
                             cuda_ms(torch, lambda: bwd_ref(*ins, want[2], dy, dstate, K.CHUNK),
                                     plain_n))}
            info = K12.bwd_info(P) if kind == "wkv6" else K13.bwd_info(P, N)
            finfo = K12.fwd_info(P) if kind == "wkv6" else K13.fwd_info(P, N)
            log(f"[recurrence] {tag}: relative errors fwd "
                + ", ".join(f"{e:.2e}" for e in errs[:3]) + "; bwd "
                + ", ".join(f"{e:.2e}" for e in errs[3:])
                + f" (tol {SCAN_KERNEL_TOL}); bitwise repeatable; forward "
                f"({'with' if ck else 'no'} checkpoints) "
                f"{_us(times['forward'][0])} us eager, {_us(times['forward'][1])} us graph "
                f"({times['forward'][0] / f_bound:.1f}x, {times['forward'][1] / f_bound:.1f}x "
                f"its bound), plain {_us(times['forward'][2])} us, bound {f_bound * 1e3:.2f} us "
                f"({f_by}, {f_bytes} B, {f_flops * entries} flop); the forward's block "
                f"{finfo['threads']} threads, {finfo['registers']} registers, "
                f"{finfo['shared_bytes']} B shared, {finfo['blocks_per_sm']} an SM, "
                f"{finfo['local_bytes']} B spilled, {B * H * finfo['blocks']} blocks; backward "
                f"{_us(times['backward'][0])} us eager, {_us(times['backward'][1])} us graph, "
                f"plain {_us(times['backward'][2])} us, bound {b_bound * 1e3:.2f} us ({b_by}, "
                f"{b_bytes} B, {b_flops * entries} flop); the backward's block "
                f"{info['threads']} threads, {info['registers']} registers, "
                f"{info['shared_bytes']} B shared, {info['blocks_per_sm']} an SM, "
                f"{info['local_bytes']} B spilled, {B * H} blocks; no single PyTorch call "
                "computes it")
            if name.endswith("train"):
                for part, (bound_ms, by), idx in (("fwd", (f_bound, f_by), slice(0, 3)),
                                                  ("bwd", (b_bound, b_by), slice(3, None))):
                    t = times["forward" if part == "fwd" else "backward"]
                    err = max(float((g - w).abs().max()) for g, w in
                              zip((out + grads)[idx], (want + want_g)[idx]))
                    rows[f"{kind}_{part}"] = {
                        "max_abs_err": err, "ms": t[0], "plain_ms": t[2], "bound_ms": bound_ms,
                        "bound_by": by, "library_ms": None}
    return rows



def _release(torch, what: str) -> None:
    """Empty the allocator's cache after a big phase and print what stays."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[memory] after {what}: {torch.cuda.memory_allocated()} B allocated, "
        f"{torch.cuda.memory_reserved()} B reserved")


def main() -> int:
    try:
        import torch
    except ImportError:
        raise SystemExit("chip_smoke: torch is not installed")
    t0 = time.perf_counter()

    def mark(what: str) -> None:
        log(f"[time] {what}: {time.perf_counter() - t0:.1f} s since the start")

    phase_card(torch)
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {__file__}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.profile import tuner

    # knobs at their defaults; each phase sets the dispatch it needs, in memory
    tuner.set_registry(tuner.TuningRegistry(path=str(ROOT / "build" / "chip_smoke_tuning.json")))
    phase_build()
    mark("build")
    # qwen3-8b first: its rounds allocate and free tensors of many sizes up to
    # 2.5 GB at a peak of about 68 GB on an 80 GB H100, which fits an
    # allocator that no earlier phase has fragmented (after them, 19 GB of
    # that card stayed reserved in split blocks and a 2.5 GB request failed)
    qwen_launches, qwen_params, qwen_corpus = phase_lm_train(torch, QWEN_RUN)
    mark("qwen3-8b training")
    qwen_serve_launches = phase_transformer_serve(torch, "qwen3-8b", qwen_params, qwen_corpus)
    del qwen_params, qwen_corpus
    _release(torch, "qwen3-8b")
    mark("qwen3-8b serve")
    # gemma3-4b second (a peak of 61.3 GB measured here on an H100 80GB,
    # 23.7 GB to spare), on the allocator qwen3-8b released; served as
    # qwen3-8b is, from 1,152-token prompts
    gemma_launches, params = phase_gemma3_train(torch)
    mark("gemma3-4b training")
    gemma_serve_launches = _serve_transformer(torch, "gemma3-4b", gemma3_config(), params, None,
                                              True, GEMMA3_PROMPT)
    del params
    _release(torch, "gemma3-4b")
    mark("gemma3-4b serve")
    # then the recurrent models, largest peak first, each phase's state
    # dropped and the allocator's cache emptied before the next
    rwkv_launches, params, corpus = phase_lm_train(torch, RWKV_RUN)
    mark("rwkv6-1.6b training")
    rwkv_serve_launches = phase_recurrent_serve(torch, "rwkv6-1.6b", params, corpus)
    del params, corpus
    _release(torch, "rwkv6-1.6b")
    mark("rwkv6-1.6b serve")
    zamba_launches, params, corpus = phase_lm_train(torch, ZAMBA_RUN)
    mark("zamba2-7b training")
    zamba_serve_launches = phase_recurrent_serve(torch, "zamba2-7b", params, corpus)
    del params, corpus
    _release(torch, "zamba2-7b")
    mark("zamba2-7b serve")
    # deepseek-v2-lite-16b (about 37 GB at qwen3-8b's bytes a parameter) after
    # the released recurrent phases
    deepseek_launches, params, corpus = phase_lm_train(torch, DEEPSEEK_RUN)
    mark("deepseek-v2-lite-16b training")
    deepseek_serve_launches = phase_transformer_serve(torch, "deepseek-v2-lite-16b", params,
                                                      corpus)
    del params, corpus
    _release(torch, "deepseek-v2-lite-16b")
    mark("deepseek-v2-lite-16b serve")
    # llava-next-mistral-7b (about 43 GB: 39 GB at qwen3-8b's bytes a
    # parameter and its 4,096-position activations) after the released ones
    llava_launches, params = phase_vlm_train(torch)
    mark("llava-next-mistral-7b training")
    # served as qwen3-8b is (B = 4 rows of 576 image tokens and a 128-token
    # prompt, prefill over 704 positions, the cache grown to 736 slots)
    llava_serve_launches = _serve_transformer(torch, "llava-next-mistral-7b", llava_config(),
                                              params, None, True)
    del params
    _release(torch, "llava-next-mistral-7b")
    mark("llava-next-mistral-7b serve")
    rows = phase_kernels(torch)
    rows.update(phase_joint_kernels(torch))
    rows.update(phase_scan_kernels(torch))
    rows.update(phase_normal_kernel(torch))
    rows.update(phase_wire_kernels(torch))
    rows.update(phase_attention_kernels(torch))
    rows.update(phase_attention_bwd(torch))
    rows.update(phase_recurrence_kernels(torch))
    # the measurements' side streams each got a cuBLAS workspace that
    # stays allocated: released, so that the paths' peak memory below
    # counts only what the paths allocate
    held = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    log(f"[kernels] cuBLAS workspaces released: {held - torch.cuda.memory_allocated()} B")
    mark("kernels")
    for mode in ("ref", "kernel"):
        phase_tiny_round(torch, mode)
        phase_tiny_decode(torch, mode)
        phase_tiny_encdec_round(torch, mode)
    phase_tiny_latency(torch)
    phase_tiny_compressed(torch)
    phase_tiny_slowpath(torch)
    phase_tiny_encdec(torch)
    phase_tiny_ladder(torch)
    tiny_lm_launches = phase_tiny_lm_rounds(torch)
    registry_launches = phase_registry_serves(torch)
    mark("tiny phases and the registry's serves")
    round_s_chunked = phase_paper_width(torch, False, "ref")[1]
    k1_launches, round_s_loop, loss_loop, _ = phase_paper_width(torch, True, "ref")
    launches, round_s_scan, loss_scan, params_scan = phase_paper_width(torch, True, "auto")
    if not math.isclose(loss_scan, loss_loop, rel_tol=SCAN_LOSS_RTOL):
        raise AssertionError(f"first-round loss on K2 {loss_scan} against the time loop's "
                             f"{loss_loop}: more than {SCAN_LOSS_RTOL} apart")
    log(f"[paper] first-round loss, use_kernel=True: K2 {loss_scan}, time loop {loss_loop}, "
        f"relative difference {abs(loss_scan - loss_loop) / abs(loss_loop):.2e} "
        f"(tol {SCAN_LOSS_RTOL})")
    mark("paper-width uncompressed runs")
    # each compressed run is its own path: its counts are set to 0 before it
    wire_launches = {k: 0 for k in WIRE_KERNELS}
    for name, flags, kw, uplink in COMPRESSED:
        counts = phase_paper_compressed(torch, name, flags, kw, uplink, loss_scan)
        for k in WIRE_KERNELS:
            wire_launches[k] += counts[k]
    mark("compressed runs")
    # the slow path's runs, each its own path; the second (packed=False)
    # must give the first's server parameters bit for bit
    params_packed = None
    for name, flags, uplink, kernels in SLOWPATH:
        counts, params = phase_paper_slowpath(
            torch, name, flags, uplink, kernels, loss_scan,
            keep_params=params_packed is None and name.startswith("int4_packed"),
            params_ref=params_packed if name.startswith("int4_graph") else None)
        if name.startswith("int4_packed"):
            params_packed = params
        for k in WIRE_KERNELS:
            wire_launches[k] += counts[k]
    del params_packed
    mark("slow-path runs")
    # the experiment ladder's runs, each its own path
    ladder_round_s = {}
    for name, flags in PAPER_LADDER:
        counts, ladder_round_s[name] = phase_paper_ladder(torch, name, flags)
        for k in WIRE_KERNELS:
            wire_launches[k] += counts[k]
    mark("ladder runs")
    # the async engine, the per-client plane, the checkpointer and the sweep
    # runner, each its own path
    phase_paper_async_parity(torch, params_scan)
    del params_scan
    counts = phase_paper_async(torch)
    for k in WIRE_KERNELS:
        wire_launches[k] += counts[k]
    phase_paper_client_eval(torch)
    phase_tiny_sweeps(torch)
    phase_paper_sweep_pair(torch)
    mark("async, client-eval, checkpoint and sweep runs")
    attn_launches = phase_whisper_serve(torch)
    mark("whisper-base serve")
    train_launches = phase_whisper_train(torch)
    mark("whisper-base training")

    phase_profile(torch, round_s_chunked, False, "ref")
    phase_profile(torch, round_s_loop, True, "ref")
    phase_profile(torch, round_s_scan, True, "auto")
    phase_profile(torch, ladder_round_s["fedsgd"], True, "auto", flags=["--engine", "fedsgd"])
    phase_host_parts(torch, round_s_scan)
    mark("profiles")
    phase_autotune(torch)
    mark("autotune")
    log(f"[time] the script's total time: {time.perf_counter() - t0:.1f} s")

    # K1 runs the main path's LSTM steps under 'ref'; K2, K3, K4 and the
    # normal kernel (FVN) under 'auto'; K5-K9 in the compressed and
    # slow-path runs (their launches summed); K10 and K11 in the
    # whisper-base, qwen3-8b, gemma3-4b, zamba2-7b, deepseek-v2-lite-16b and
    # llava-next-mistral-7b serves and trainings, the registry's serves and
    # the tiny LM rounds, K10's backward in the trainings and the tiny rounds
    # (each path's launches summed); each row of the instantiations for
    # heads of 256 (``_wide_counts``) takes its launches out of its kernel's
    # row, so that no launch counts twice
    for name in ("lstm_gates_fwd", "lstm_gates_bwd"):
        launches[name] = k1_launches[name]
    launches.update(wire_launches)
    attn_paths = (attn_launches, train_launches, qwen_launches, qwen_serve_launches,
                  zamba_launches, zamba_serve_launches, deepseek_launches,
                  deepseek_serve_launches, llava_launches, llava_serve_launches, gemma_launches,
                  gemma_serve_launches, registry_launches, tiny_lm_launches)
    for wide in _wide_counts():
        base = wide.removesuffix("_256")
        launches[wide] = sum(path.get(wide, 0) for path in attn_paths)
        launches[base] = sum(path.get(base, 0) for path in attn_paths) - launches[wide]
    # K12 in the rwkv6-1.6b training and serve, K13 in zamba2-7b's (and each
    # in the registry's serves of their smoke configs)
    for name in ("wkv6_fwd", "wkv6_bwd"):
        launches[name] = rwkv_launches[name] + rwkv_serve_launches[name] \
            + registry_launches.get(name, 0)
    for name in ("ssm_scan_fwd", "ssm_scan_bwd"):
        launches[name] = zamba_launches[name] + zamba_serve_launches[name] \
            + registry_launches.get(name, 0)
    gates, scan, joint, wire, attn, normal = (
        "src/repro_torch/kernels/csrc/" + f for f in
        ("lstm_gates.cu", "lstm_scan.cu", "rnnt_joint.cu", "wire_pack.cu", "attention.cu",
         "threefry_normal.cu"))
    table = {  # kernel: (source, the TPU kernel it replaces)
        "lstm_gates_fwd": (gates, "src/repro/kernels/lstm_gates.py:43"),
        "lstm_gates_bwd": (gates, "src/repro/kernels/lstm_gates.py:92"),
        "lstm_scan_fwd": (scan, "src/repro/kernels/lstm_gates.py:202"),
        # the recurrence of _scan_bwd_kernel (:235-279, :283-292): its gate
        # recompute (two kernels) and the recurrence, one call
        "lstm_scan_bwd": (scan, "src/repro/kernels/lstm_gates.py:295"),
        # of which the gate recompute alone (_scan_bwd_kernel, :260-263)
        "lstm_scan_bwd_gates": (scan, "src/repro/kernels/lstm_gates.py:260"),
        # the dw_hh accumulation of _scan_bwd_kernel (:280-282)
        "lstm_scan_dw": (scan, "src/repro/kernels/lstm_gates.py:280"),
        # K3 (rnnt_joint_fused, :86) in three launches: h, the logits and
        # their running log-sum-exp of its _kernel (:42, :52, :58)
        "rnnt_joint_fwd": (joint, "src/repro/kernels/rnnt_joint.py:86"),
        "rnnt_joint_fwd_h": (joint, "src/repro/kernels/rnnt_joint.py:42"),
        "rnnt_joint_fwd_logits": (joint, "src/repro/kernels/rnnt_joint.py:52"),
        "rnnt_joint_fwd_lse": (joint, "src/repro/kernels/rnnt_joint.py:58"),
        # K4 (rnnt_joint_bwd_fused, :251) in five launches: h, which both of
        # its kernels recompute (_bwd_eg_kernel :175, _bwd_w_kernel :218)
        "rnnt_joint_bwd_h": (joint, "src/repro/kernels/rnnt_joint.py:175"),
        # the logits and their cotangent (_dlogits, :148, in both kernels)
        "rnnt_joint_bwd_dlogits": (joint, "src/repro/kernels/rnnt_joint.py:148"),
        # dh and dpre (_bwd_eg_kernel)
        "rnnt_joint_bwd_dh": (joint, "src/repro/kernels/rnnt_joint.py:175"),
        # the de/dg sums of _bwd_eg_kernel's last step and of the dg partials
        "rnnt_joint_bwd_reduce": (joint, "src/repro/kernels/rnnt_joint.py:211"),
        # dW and db (_bwd_w_kernel)
        "rnnt_joint_bwd_dw": (joint, "src/repro/kernels/rnnt_joint.py:218"),
        # K5 (keyed) and K6 (streamed, nearest, :170 and :204) in one template
        "wire_quantize": (wire, "src/repro/kernels/wire_pack.py:286"),
        "nibble_pack": (wire, "src/repro/kernels/wire_pack.py:66"),
        "nibble_unpack": (wire, "src/repro/kernels/wire_pack.py:90"),
        "dequantize": (wire, "src/repro/kernels/wire_pack.py:112"),
        "topk_scatter_add": (wire, "src/repro/kernels/wire_pack.py:441"),
        # the serial (:352) and the segmented (:387) kernel in one
        "topk_unpack": (wire, "src/repro/kernels/wire_pack.py:352"),
        # K10's two routes (the rule in kernels/flash_attention.py:route)
        "flash_attention_wgmma": (attn, "src/repro/kernels/flash_attention.py:70"),
        "flash_attention_simt": (attn, "src/repro/kernels/flash_attention.py:70"),
        "flash_decode": (attn, "src/repro/kernels/decode_attention.py:62"),
        # their instantiations for heads of 256 (``_wide_counts``: the
        # forward's two warpgroups, the CUDA-core tiles of 256; K11 sized
        # for 256 columns)
        "flash_attention_wgmma_256": (attn, "src/repro/kernels/flash_attention.py:70"),
        "flash_attention_simt_256": (attn, "src/repro/kernels/flash_attention.py:70"),
        "flash_decode_256": (attn, "src/repro/kernels/decode_attention.py:62"),
        # no pallas_call: jax.grad of the model's jnp attention
        # (blockwise_attention), which the training path differentiates; its
        # two routes (the rule in kernels/flash_attention.py:bwd_route)
        "flash_attention_bwd_wgmma": ("src/repro_torch/kernels/csrc/attention_bwd_wgmma.cu",
                                      "src/repro/models/attention.py:84"),
        "flash_attention_bwd_simt": ("src/repro_torch/kernels/csrc/attention_bwd.cu",
                                     "src/repro/models/attention.py:84"),
        # at heads of 256: the column halves, the CUDA-core tiles of 256
        "flash_attention_bwd_wgmma_256": ("src/repro_torch/kernels/csrc/attention_bwd_wgmma.cu",
                                          "src/repro/models/attention.py:84"),
        "flash_attention_bwd_simt_256": ("src/repro_torch/kernels/csrc/attention_bwd.cu",
                                         "src/repro/models/attention.py:84"),
        # no pallas_call: FVN's jax.random.normal and its scaled sum, which
        # XLA fuses (perturb, :40-48; the gaussian adversary's and the DP
        # noise's the same)
        "threefry_normal": (normal, "src/repro/core/fvn.py:45"),
        # no pallas_call: the reference's lax.scan of checkpointed chunks over
        # the WKV-6 step (rwkv_time_mix, :126-131) and its jax.grad
        "wkv6_fwd": ("src/repro_torch/kernels/csrc/wkv6.cu", "src/repro/models/rwkv.py:140"),
        "wkv6_bwd": ("src/repro_torch/kernels/csrc/wkv6.cu", "src/repro/models/rwkv.py:140"),
        # no pallas_call: the same over Mamba2's step (mamba_forward,
        # :110-116; mamba_step the one-step case) and its jax.grad
        "ssm_scan_fwd": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                         "src/repro/models/ssm.py:122"),
        "ssm_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                         "src/repro/models/ssm.py:122"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches[name], **rows[name])
               for name, (src, replaces) in table.items()]
    # K10's CUDA-core routes serve fp32 and other widths: the main path (the
    # bf16 serve and training at head width 64) takes the tensor cores by
    # the rules
    off_path = {"flash_attention_simt", "flash_attention_bwd_simt", "flash_attention_simt_256",
                "flash_attention_bwd_simt_256"}
    idle = [k["name"] for k in kernels if k["launches"] == 0 and k["name"] not in off_path]
    if idle:
        raise AssertionError(f"kernels of the main path never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
