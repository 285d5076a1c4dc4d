#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
of which fails the run with a non-zero exit:

1. device -- a CUDA card must be present (no CPU fallback); prints its
   name and power limit and the torch/CUDA versions;
2. build -- compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel);
3. kernels -- each kernel against its plain PyTorch version on the card at
   the main paths' shapes (atol = rtol = 1e-5; the NLL to 1e-5 relative);
   ``logistic_stats`` at the main path's n, a ragged n, n below one block,
   a misaligned m (the scalar path) and extreme margins, three launches in
   a row bit-equal (the NLL's ticket resets itself);
   ``gram_cd`` at M=16 and F = 64, 128 (G resident in shared memory), 256,
   1024 (G streamed through a ring) and 50 (no TMA), two launches
   bit-equal; ``blocked_cd`` at B = 16 and 8 on a tile where modes 0, 1
   and 2 all occur, at F = 256 and at B = 10, its in-kernel modes
   (``modes_out``) equal to ``blocked_cycle_modes`` or, where not, the
   block's ratio within 4 ulp of the threshold, and a tile exactly at the
   threshold, and a tile whose modes move with the threshold at
   ``dom_tol`` 0.5 and 0.99 against ``blocked_cd_ref(dom_tol=)`` and
   ``blocked_cycle_modes(dom_tol=)``; both at B=1 bit-equal to each
   other at F = 128 and 256; both on strided beta/dbeta0 views bit-equal
   to contiguous inputs; the tile kernels' division bit-equal to IEEE
   division on 2^32 pairs;
4. main path -- ``LogisticL1(...).fit(DenseDesign(X), y, lam)`` at the
   paper's epsilon scale (320,000 x 2000 training rows, generated on the
   card), M=16 blocks of one 128-wide tile, lam = lambda_max / 16, in both
   cycle modes: status OK, objective history non-increasing (within the
   snap-back tolerance), every kernel of the path launched; launch counts
   are zeroed just before each fit and read just after; each mode's
   second fit runs under ``analysis.sanitize.transfer_sanitizer`` at
   exactly k + 1 reads through the engine's doors (anything else that
   reads a CUDA tensor or synchronises fails it) and is bit-equal to the
   first;
5. agreement -- a reduced fit (8192 x 2000) on the card against the same
   fit on the CPU (plain versions): relative objective gap < 1e-4, betas
   within rtol 1e-2 / atol 1e-3; the card fit's synchronising calls, as
   torch's sync debug mode sees them, must equal the engine's count;
6. sparse cell -- webspam-shaped slabs made on the card (252,000 training
   and 63,000 test rows, p = 2^20 features at webspam's density,
   ``GLM_WEBSPAM``): ``slab_gram`` (which gathers its operands itself)
   and ``slab_spmv`` against their plain versions (for ``slab_gram`` the
   plain path's sentinel-zeroed gathers through the match join) and the
   densify oracles at the cell's shapes, on adversarial slabs (duplicate
   rows, sentinels anywhere with values parked on them, empty features,
   unsorted slots), for ``slab_spmv`` on a "hub" row whose run crosses
   warps and blocks and, for ``slab_gram``, on a tile whose row-sorted
   order does not fit in shared memory, each bit-equal across two
   launches; ``slab_spmv`` with the tile's dbeta update fused bit-equal to
   the separate ``+=``, and with the order built by the dispatch
   (``order=None``) bit-equal to the layout's; an order without its
   values refused before any launch; and at the screened path's K classes
   (8, 16, 32, 64 and the cell's 94, slots trimmed as a working-set gather
   trims them), laid out by ``layout_slabs`` into one tile per block, as
   the smallest restricted solve lays them out; ``slab_spmv``'s path mode
   (``ops.slab_path_spmv``: each example row reads its own row of a
   stacked (L, M * T) path) against its plain version at a local serve
   store's shape (1 x 2^20 x 8) and a (1, 16) mesh store's (16 x 65,536 x
   8), on the adversarial and hub slabs, with random ``lam_idx`` over
   L = 8, at a uniform ``lam_idx == l`` bit-equal to ``slab_spmv`` with
   ``betas[l]`` for every l, two launches bit-equal;
7. sparse path -- ``LogisticL1(opts, mesh=make_dev_mesh(1, 16)).fit(
   SlabDesign(...), y, lam)`` with lam = lambda_max / 16 in both cycle
   modes: the strategy picks the slab-native solver, status OK, monotone
   objective, ``slab_gram``, ``slab_spmv``, ``logistic_stats`` and the
   mode's tile kernel each launched at least once per outer iteration,
   host syncs = iterations + 2 (one entry read of the slabs' largest
   row), held-out accuracy through ``decision_function`` on the test
   slabs, fit wall, ms per iteration and peak memory (the profile phase
   counts the device launches per tile step of each mode); a digest of
   the bits of beta, the history and the scores, to diff two runs;
8. path -- the screened regularization path (paper Algorithm 5)
   ``LogisticL1(opts, mesh=make_dev_mesh(1, 16)).path(SlabDesign(...), y,
   path_len=8, eval_fn=make_design_eval(test slabs))`` on the cell, both
   cycle modes: every point status OK; an independent KKT pass per point
   (margins by the plain scatter, |g| by the plain ``slab_corr``): no
   feature with beta_j = 0 outside the point's working set may have
   |g_j| > lam (1 + 1e-3) + 1e-7 (those inside it, left at 0 by the
   restricted solve's stopping rule, are reported); f non-increasing
   along the grid; the lambda_max/16 point's f within 1e-4 of phase 7's
   fit; ``logistic_stats``, ``slab_gram``, ``slab_spmv`` and the mode's
   tile kernel each launched at least once per restricted-solve
   iteration; host reads equal to the driver's (from its telemetry) plus
   each solve's iterations + 2 plus the eval's; the first two points
   run under the transfer sanitizer, at exactly the driver's and the
   solves' reads; the blocked path runs under ``compile_sanitizer(0)``
   (no kernel built or loaded). Per point: lambda, active, capacity, k_cap, KKT rounds,
   deferred, nnz, f, iterations, wall, test AUPRC and accuracy; then the
   path's wall, its wall down to lambda_max/16, one screen pass, the
   peak memory and a digest of the bits of the betas and f;
8a. streamed path -- the cell split into 16 feature-range buckets of
   65,536 features (a ``SlabBuckets``), ``LogisticL1.path`` on a (1, 16)
   mesh, sequential, ``path_len`` 4 (lambda_max/2 ... /16), with the
   path phase's options and eval, twice from the same buckets: resident
   on the card, and from pinned host buckets under ``device_budget_bytes
   = slab_nbytes(tile) // 4`` (4 of the 16 buckets; the floor is 2).
   Gates: ``Strategy.residency`` "streamed"; betas, f, nnz and every
   screen count bit-equal to the resident run; evictions > 0, misses >
   buckets, bytes moved > the slab bytes, resident bytes within the
   budget; ``logistic_stats``, ``slab_gram``, ``slab_spmv`` and
   ``gram_cd`` launched at least once per restricted-solve iteration;
   the same host reads as the resident run; the first two streamed
   points under sync debug mode synchronise only through the engine's
   door. Both runs are traced (``obs.observe()``): the gate above holds
   with tracing on, as many ``bucket_stream`` spans as misses, the
   ``residency.tile<T>`` callback equal to ``residency_stats()``. Prints
   both runs' walls, their span split (``path``'s direct children, the
   totals of screen_round, restricted_solve, kkt_check, point_finish,
   lambda_grid and bucket_stream, the time outside spans) and the
   streamed-minus-resident difference per phase, one screen pass each
   (CUDA events), the bytes moved per pass and their rate, and peak
   memory;
8b. serve -- phase 8's sequential path (8 points, p = 2^20) through
   ``PathResult.save`` / ``load`` (betas bit-equal) and
   ``PathStore.from_checkpoint`` into a local store and a (1, 16) mesh
   store (tile 128); traffic from ``launch/serve_glm.make_traffic`` (1 ...
   376 tokens per request, tokens from [0, 4p), lambdas uniform over the
   8 points, ``max_batch`` 256): one warm batch, then 20 drain -> score
   rounds per store. Gates: on the warm batch, served scores bit-equal
   to ``decision_function`` at all 8 lambdas (``serve_glm.smoke_check``);
   one ``slab_spmv`` path-mode launch and one counted host read per
   batch, nothing else synchronising under sync debug mode; a hot swap
   to a 2-point sub-path gives version v -> v+1 without dropping the
   batch; a version with one NaN coefficient is quarantined and the
   batch rescored on the previous one. Prints scores/s, one batch's time
   by stage (host encode and pack, the copy, ``slab_order``, the kernel),
   the checkpoint's save and load wall and peak memory; the local store's
   rounds, swaps and stage timings run under ``obs.observe()``: its
   encode, drain and score spans per batch (each request encoded, each
   round drained and scored once), the swap spans, and the
   ``serve.latency_s`` percentiles (every timed request) and the last
   ``serve.queue_depth``;
8c. chaos -- the resilience drills on the cells above, under the port's
   ``obs.observe()``, every ``faults.*``, ``retry.*`` and ``serve.swaps``
   counter equal to what the drills inject: nan-inject (phase 4's
   sequential fit with NaN margins at iteration 3, one solve: status
   NONFINITE_OBJECTIVE after 2 iterations, beta finite, the history an
   exact prefix of phase 4's, the host reads and kernel launches of a fit
   cut at 3 iterations, a healthy fit after it bit-equal to phase 4's);
   kill-resume (phase 8's sequential path with its eval, checkpointed at
   every point, killed after 3 points, resumed for 2 points under sync
   debug mode, where only the engine's door may synchronise, the
   checkpoint reads included, killed again, resumed to the end: betas,
   lambdas, f, nnz, iterations, statuses, screen counts and metrics
   bit-equal to phase 8's path, host reads = phase 8's + one per
   checkpoint + one lambda_max per resume; the walls and the checkpoint
   bytes and ms per point; the three runs' span split beside phase 8's
   wall, its solves and its eval); lost-bucket (phase 8a's streamed cell: two
   lost puts retried, bit-equal to the resident path; three lost puts
   after half the puts kill the checkpointed path with
   ``RetriesExhausted``, and a new design from the same host buckets
   resumes it bit-equal); corrupt (phase 8b's checkpoint bit-flipped,
   truncated and stripped of its meta: ``PathStore.from_checkpoint``
   refuses each with a typed error; the kill-resume directory's newest
   slot bit-flipped: ``load_latest`` rolls back to the slot before);
   overload (phase 8b's path on a local store, one failed swap, 5 ms per
   dispatch: a bounded queue rejects, expired requests are shed, a NaN
   version is quarantined and the batch rescored bit-equal, one path-mode
   launch and one host read per scored batch); prints its wall;
9. sparse agreement -- an 8192 x 4096 slab fit on the card against the
   same fit on the CPU, both slab-native, and one ``densify=True`` fit on
   both: relative objective gaps < 1e-4, and after a fixed 8 iterations
   (both sides taking the same steps) betas within rtol 1e-2 / atol 1e-3;
   the slab-native card fit under torch's sync debug mode synchronises
   only through the engine's door; then paths on the card against the
   CPU: 8192 x 4096 slabs on a (1, 16) mesh, flat and bucketed
   (``path_len`` 4), and a local dense 8192 x 2000 path (``path_len`` 6): per point lambda within
   rtol 1e-6 and a relative f gap < 1e-4, betas within rtol 1e-2 / atol
   1e-3 where the support is at most n / 8, and nnz, active, capacity,
   KKT rounds and the beta gap side by side; the flat path's CPU run also
   against a densify-once CPU path (two plain solvers, no card: the
   spread of beta at the same objective deeper on the path);
9a. process mesh -- d-GLMNET across ``torch.distributed`` ranks
   (``launch.mesh.ProcMesh``): gloo sums and broadcasts a CUDA tensor
   between two spawned ranks; a one-rank NCCL mesh (1, 16) fits the
   webspam-shaped cell with phase 7's lambda and options (sequential)
   bit-equal to phase 7's fit (betas and history), at iterations + 2
   host reads, under sync debug mode nothing synchronising but the
   engine's door, every kernel of the path launched; then four
   co-located gloo ranks (spawned ``--mesh-rank`` processes, each under
   a deadline), a (2, 16) mesh of 2 data x 2 model ranks of 8 blocks,
   each drawing the cells from their seeds and keeping only its piece,
   its example shard of its half of the padded features (gated: its
   resident slab bytes are its piece's, the epsilon shard (n / 2, 1024)):
   the cell as (p, 2, K') slabs fitted for a fixed 4 iterations, twice,
   against phase 7's fit cut at 4 (objective gap < 1e-4, betas within
   rtol 1e-2 / atol 1e-3; the ranks' betas and histories bit-equal; each
   kernel launched on every rank in every iteration), the second time on
   the same ranks as a (2, 1, 16) pod mesh, bit-equal to the first; the
   same fit on the cell as 16 feature-range buckets streamed under a
   quarter of each rank's piece bytes (8 pieces a rank through a budget
   of 2), bit-equal to the resident fit at the same host reads, each
   rank's bytes, transfers, evictions and ms per iteration printed; a
   nan-inject at iteration 2 of a fit cut at 3 (every rank
   NONFINITE_OBJECTIVE after 1 iteration, a finite beta; the healthy
   fit after it the resident fit's first iterations bit for bit); the
   epsilon cell on (2, 16) against phase 4's
   sequential fit (gap < 1e-4); a 2-point path (lambda_max/2, /4) on
   (2, 16), checkpointed on every rank, killed after point 1 and resumed
   for point 2 (the digest of its betas printed, the same on every
   rank), every point OK, the independent KKT pass of phase 8 at each
   point and each f within 1e-4 of phase 8's; a ``PathStore`` of that
   path on (2, 16) (each rank its (2, p / 2) block) serving one batch of
   phase 8b's traffic shape (256 requests): on every rank the whole
   batch's scores, bit-equal across ranks and to ``decision_function``
   through the same mesh at every lambda, within 1e-5 (relative to the
   largest score) of a local store's scores of the same path; ``decision_function`` of
   phase 7's beta on (2, 16): all n rows on every rank, bit-equal across
   ranks, within 1e-5 (relative to the largest score) of phase 7's
   scores. Prints, per rank, its piece's bytes beside the whole shard's,
   the wall and ms per iteration, the collectives per iteration and their
   bytes (and the path's model calls per lambda), peak memory beside the
   parent commit's, and the card's name and power limit (co-located
   gloo ranks stage every collective through the host and share one
   card: not a multi-card speed);
10. LM kernels -- ``flash_attention`` against its plain version at the
   serving cell's attention shape (B=8, S=2048, H=32, Hk=4, D=64), one
   Hk == H shape, the reference's sweep shapes, the probe's chunk and
   the MoE cell's shape (B=8, S=2048, H=40, Hk=8, D=128) and the dense
   cells' (phase 17: H/Hk = 16/2, 20/20 and 16/8, D=128), in float32 (atol 2e-5)
   and bfloat16 (atol 3e-2, and on every element within half a bf16 ulp
   plus 2e-5 of the plain version's float32 result before its cast),
   causal and full, two launches bit-equal;
11. LM serving cell -- tinyllama-1.1b at full width (22 layers, d_model
   2048, bf16, weights drawn on the card from seed 0) serves 8 prompts of
   2048 tokens plus 32 greedy tokens through ``repro_torch.launch.serve``
   ``generate``: exactly 22 ``flash_attention`` launches (one per layer
   in prefill, none in decode), the last prefill logits through the
   kernel against the plain chunked path, and one host read for the
   whole generation under torch's sync debug mode; prefill ms, decode ms
   per token, tokens/s and peak memory;
12. LM agreement -- tinyllama's float32 ``smoke()`` model with a 128-token
   prompt on the card against the same model on the CPU: prefill logits
   within 1e-4, 8 greedy tokens equal;
12a. paper -- the paper's comparison (section 4.3): ``tg_pass`` against
   its plain version on the card at (M=16, 2048 steps, p=2000; the
   epsilon cell's rows), (M=4, 1000 steps, p=4099, theta 0.05; rows not
   16-byte aligned) and (M=2, 500 steps, p=8192, the widest it takes),
   bit for bit, two launches bit-equal; a truncated-gradient fit (8192 x
   2000, 16 machines, 3 passes) on the card against the CPU's (rtol 1e-4,
   atol 1e-6) and, shuffled, with no synchronising call under sync debug
   mode; Table 3 on the epsilon cell at full width
   (``repro_torch.paper.table3_timing``: iterations, ms per iteration,
   the line search's share by CUDA events, TG ms per pass); Figure 1 on
   it (the 10-point d-GLMNET path against TG at 3 lambdas x 3 learning
   rates x 8 passes, both scored on the 80,000 test rows by one device
   eval: every point OK, every snapshot finite, TG's last-pass nnz at
   lambda_max/16 at most its nnz at /256 for every rate; the best AUPRC
   of each side and ``dglmnet_wins`` printed, not gated); the ablation at
   its own shape (n = 4096, p = 256, 36 fits, each objective finite);
   the sparse probe on phase 11's tinyllama weights (2048 prompts of 128
   tokens with marker token 7, features in chunks of 256 through the
   flash kernel, exactly 22 launches per chunk, finite; an 8-point
   probe path on a 4/5 split, every point OK, nnz and AUPRC printed);
12b. LM training cell -- tinyllama-1.1b at full width (bf16 weights drawn
   on the card from seed 0, float32 AdamW moments, remat on) trained
   through ``train.make_train_step`` on batches of 8 x 2048 tokens of
   ``data.lm_data.zipf_corpus`` (vocab 32,000) under ``warmup_cosine``:
   one warm-up step (the schedule's step 0, lr 0), then 4 timed steps
   (CUDA events) under torch's sync debug mode. Gates: every loss and
   grad norm finite, the last loss below the first, no synchronising
   call and no ``flash_attention`` launch in the steps, the kernel's
   wrapper (and a training forward that asks for it) refusing an operand
   that requires grad, and a prefill of the trained weights through the
   kernel (22 launches) within phase 11's bound of the plain chunked
   path. Prints ms per step, tokens/s, the share of the bound (8 N
   FLOP a token at the bf16 peak: forward, backward and the remat
   forward), peak memory and one more step's device time by kernel
   (torch.profiler);
12c. LM training agreement -- tinyllama's float32 ``smoke()`` model
   trained 3 steps on the card and on the CPU from the same numpy
   weights and batches: losses within 1e-4 relative, every weight and
   moment within rtol 1e-4 / atol 1e-5;
13. times -- each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (CUDA events, median of 25
   launches after warm-up, L2 flushed before each), beside its bound;
   ``slab_spmv`` also without its fused dbeta update and at the margins'
   shape (16 blocks of 65,536 features), beside its byte bound, and its
   path mode at both serve shapes (no single PyTorch call gathers a
   per-row coefficient, so its library column is null); ``tg_pass`` over
   one epsilon pass (16 x 20,000 steps; no library call), every timed
   launch bit-equal to its plain version, with ns per step beside its
   byte bound, the least step and this design's chain;
14. profile -- device time by kernel (torch.profiler) for one dense fit
   per cycle mode, a 2-pass truncated-gradient fit, a 3-iteration sparse
   fit per cycle mode (with device launches per tile step), the path's
   first two points in the sequential mode (busy and idle time, and
   its screen passes, gathers and layout sorts timed apart with CUDA
   events), one LM prefill and 8 decode steps after it; a profile with
   no device time fails the run;
15. LM MoE cell -- after tinyllama's weights are freed,
   llama4-scout-17b-a16e at full width (d_model 5120, 40/8 heads of 128,
   16 experts of 8192 top-1 and a shared expert, vocab 202,048; bf16,
   weights drawn on the card from seed 0) cut to its first 4 of 48
   layers, serving phase 11's batch through ``generate``: one
   ``flash_attention`` launch per layer in a generation and in a prefill,
   that prefill's last logits within 0.25 of their std of the plain
   chunked path's (0.22 here), the next tokens agreeing on 7 of 8 prompts
   or more, finite, one host read per generation under sync debug mode; prints
   prefill ms, decode ms per token, peak memory, the prefill's
   ``moe_drop_frac`` and the parameter counts (total, active) beside the
   weights' bytes, profiles one prefill and 8 decode steps; its float32
   smoke model on the card against the CPU (phase 12's check); the
   kernel alone at the cell's attention shape beside its bound and SDPA;
16. LM SSM cell -- mamba2-2.7b whole (64 layers, 80 SSD heads of 64,
   d_state 128, chunk 256, tied vocab 50,280; bf16), the same serving and
   gates with no attention layer (0 flash launches), its smoke model card
   against CPU, and on the card's float32 smoke model a prefill of 128
   tokens then one decode step within 1e-4 of a prefill of 129;
17. LM QKV-bias and GQA cells -- qwen2.5-3b (36 layers, 16/2 heads of
   128, QKV bias), qwen1.5-4b (40 layers, 20/20 heads, QKV bias) and
   internlm2-1.8b (24 layers, 16/8 heads), each whole (bf16, weights
   drawn on the card from seed 0), through phase 15's serving and gates:
   one ``flash_attention`` launch per layer in a generation and in a
   prefill, the prefill's last logits within 0.25 of their std of the
   plain chunked path's (0.22 for internlm2, about 10 for the tied qwens,
   whose logits' std is near 40), the same next tokens, one host read
   per generation, a profile of qwen2.5-3b's prefill and decode;
   each float32 smoke model (its
   QKV biases drawn non-zero) card against CPU; the kernel alone at each
   cell's attention shape beside its bound and SDPA (rows 6c-6e);
18. LM MLA cell -- deepseek-v3-671b at full width (d_model 7168, MLA
   with 128 heads, q_lora 1536, kv_lora 512, rope 64, nope 128, v 128;
   256 experts of 2048 top-8 plus a shared one; vocab 129,280; bf16) cut
   to its first 4 of 61 layers (3 dense, 1 MoE) and without its MTP
   head, through the same serving and gates with 0 flash launches (MLA's
   q and v heads differ in width, so its prefill takes the chunked path,
   as the reference's does; its decode is the absorbed form over the
   latent cache); prints the prefill's ``moe_drop_frac``; its float32
   smoke model (MTP head kept) card against CPU, and a prefill of 128
   tokens then one absorbed decode step within 1e-4 of a prefill of 129.

Prints the kernel table as one JSON line (``flash_attention``'s row 6 at
the tinyllama cell, and rows 6b-6e at the MoE and dense cells' shapes,
each with its ``cell``, ``row`` and ``shape``), then the card's name and
power limit, then a last JSON line ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --sparse-host [--src DIR]`` runs
only the device and build phases and the sparse cell's host-side
timings (two fits per cycle mode, in turns, with the host thread's CPU
time per tile step; ten runs of one iteration's tile loop per mode; the
host time of the tile step's residual update; and ``slab_spmv`` at the
margins' shape with and without a built order) for
the ``repro_torch`` under ``DIR/`` (default: this checkout's ``src``):
run it on two checkouts in turns to compare them. It prints no ``ok``
line.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from importlib import import_module
from dataclasses import replace
from datetime import timedelta
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
# H100 SXM data-sheet peaks used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12              # dense tensor-core rate


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def digest(torch, *values) -> str:
    """The first 16 hex digits of the SHA-256 of ``values`` (tensors or
    sequences of floats) as float32 bytes: two runs that print the same
    digest hold the same bits."""
    import hashlib

    h = hashlib.sha256()
    for v in values:
        t = v.detach().cpu() if torch.is_tensor(v) else torch.tensor(list(v), dtype=torch.float64)
        h.update(t.to(torch.float32).contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events), with the L2
    cache flushed before each call, as the main path leaves it cold."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float, n_flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def under_sync_debug(torch, fn):
    """Run ``fn()`` under torch's sync debug mode; returns its result and
    the synchronising calls by call site (with one stack each)."""
    sites, stacks = Counter(), {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            site = f"{Path(filename).name}:{lineno}"
            sites[site] += 1
            stacks.setdefault(site, "".join(traceback.format_stack(limit=10)[:-1]))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites, stacks


def check_sync_sites(sites, stacks, tag: str):
    """Fail if anything but the engine's counted door synchronised."""
    stray = {site: stack for site, stack in stacks.items() if not site.startswith("engine.py:")}
    for site, stack in stray.items():
        print(f"[{tag}] synchronising call at {site}:\n{stack}")
    check(not stray, f"the card fit synchronised outside the engine's host reads: {dict(sites)}")


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def tile_inputs(torch, gen, M: int, F: int, n: int = 4096, kind: str = "random"):
    """Gram tiles G = Xf^T diag(w) Xf and c = (w Xf)^T r as the main path
    builds them. ``kind="modes"`` makes each 16-wide block of features
    independent, pairwise-correlated across halves, or duplicated, so the
    blocked cycle's modes 0, 1 and 2 all occur; ``kind="graded"``
    correlates the halves of block g by g/8 (g mod 8), so the blocks'
    Gershgorin ratios spread from about 0.2 to 1 and the modes move with
    the threshold."""
    dev = "cuda"
    Xf = torch.randn(M, n, F, generator=gen, device=dev)
    if kind == "graded":
        for lo in range(0, F, 16):
            a = ((lo // 16) % 8) / 8
            Xf[:, :, lo + 8:lo + 16] = (a * Xf[:, :, lo:lo + 8]
                                        + (1 - a * a) ** 0.5 * Xf[:, :, lo + 8:lo + 16])
    if kind == "modes":
        for lo in range(0, F, 16):
            g = (lo // 16) % 3
            if g == 1:      # second half ~ first half: only halves dominant
                Xf[:, :, lo + 8:lo + 16] = (Xf[:, :, lo:lo + 8]
                                           + 0.05 * Xf[:, :, lo + 8:lo + 16])
            elif g == 2:    # duplicated feature: nothing dominant
                Xf[:, :, lo:lo + 16] = Xf[:, :, lo:lo + 1].clone()
    w = 0.05 + 0.2 * torch.rand(n, generator=gen, device=dev)
    r = torch.randn(M, n, generator=gen, device=dev)
    wX = w[None, :, None] * Xf
    G = (Xf.transpose(1, 2) @ wX).contiguous()
    c = (wX.transpose(1, 2) @ r[..., None])[..., 0].contiguous()
    beta = 0.1 * torch.randn(M, F, generator=gen, device=dev)
    dbeta0 = 0.01 * torch.randn(M, F, generator=gen, device=dev)
    lam = float(c.abs().mean())
    return G, c, beta, dbeta0, lam


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi[0] if smi else 'unreadable'}")
    return smi[0] if smi else "unknown"


def phase_build(torch):
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    # allow[torch-bench-timing]: times the nvcc subprocesses; no CUDA work in between
    t_nvcc = time.perf_counter() - t0
    for name, log in build.ptxas_log.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: " + " | ".join(lines))
    print(f"[build] nvcc (parallel) {t_nvcc:.2f} s "
          f"{ {k: round(v, 2) for k, v in secs.items()} }")


def phase_kernels(torch, gen):
    from repro_torch.core.subproblem import blocked_cycle_modes
    from repro_torch.kernels import blocked_cd, ref
    gram_cd = import_module("repro_torch.kernels.gram_cd")
    logistic_stats = import_module("repro_torch.kernels.logistic_stats")

    errs = {}
    # logistic_stats: main-path n, a ragged n, n below one block, a
    # misaligned m (the scalar path), and extreme margins; three launches in
    # a row must be bit-equal (the NLL's ticket resets itself)
    for label, n, scale in (("n=320000", 320_000, 4.0), ("ragged n=100003", 100_003, 4.0),
                            ("n=1000, below one block", 1000, 4.0),
                            ("misaligned n=99999", 99_999, 4.0),
                            ("margins +-40/+-100", 4099, 0.0)):
        if scale:
            m = scale * torch.randn(n + 1, generator=gen, device="cuda")
            m = m[1:] if label.startswith("misaligned") else m[:n]
        else:
            m = torch.tensor([40.0, -40.0, 100.0, -100.0, 88.0, -88.0, 0.0],
                             device="cuda").repeat(-(-n // 7))[:n].contiguous()
        y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1.0, -1.0)
        outs = [logistic_stats.logistic_stats_kernel(m, y) for _ in range(3)]
        w, z, nll = outs[0]
        w0, z0, nll0 = ref.logistic_stats_ref(m, y)
        torch.cuda.synchronize()
        ok = (torch.allclose(w, w0, rtol=TOL, atol=TOL)
              and torch.allclose(z, z0, rtol=TOL, atol=TOL)
              and abs(float(nll) - float(nll0)) <= TOL * abs(float(nll0)))
        same = all(torch.equal(a, b) for o in outs[1:] for a, b in zip(o, outs[0]))
        e = max(max_err(w, w0), max_err(z, z0))
        print(f"[kernels] logistic_stats {label}: max|dw|,|dz| {e:.3g}, "
              f"nll {float(nll):.6f} vs {float(nll0):.6f}, three launches "
              f"{'bit-equal' if same else 'DIFFERENT'} -> {'ok' if ok and same else 'MISMATCH'}")
        check(ok, f"logistic_stats {label} disagrees with its plain version")
        check(same, f"logistic_stats {label}: three launches differ")
        errs["logistic_stats"] = max(errs.get("logistic_stats", 0.0), e)

    # gram_cd: resident tiles (F <= 128), the ring (F = 256, 1024), and
    # F = 50, whose rows are not whole 16-byte units (plain loads, no TMA)
    for M, F in ((16, 128), (1, 256), (16, 64), (16, 256), (16, 1024), (16, 50)):
        G, c, beta, db0, lam = tile_inputs(torch, gen, M, F)
        plan = gram_cd.chunk_plan(F, 3)
        d = gram_cd.gram_cd_kernel(G, c, beta, db0, lam, 1e-6)
        again = gram_cd.gram_cd_kernel(G, c, beta, db0, lam, 1e-6)
        d0 = ref.gram_cd_ref(G, c, beta, db0, lam, 1e-6)
        torch.cuda.synchronize()
        e = max_err(d, d0)
        ok = torch.allclose(d, d0, rtol=TOL, atol=TOL)
        same = torch.equal(d, again)
        print(f"[kernels] gram_cd M={M} F={F} ({'resident' if plan.resident else 'ring'}: "
              f"{plan.chunks} chunks of {plan.rows} rows, {plan.stages} stages, "
              f"{plan.smem} B shared): max|dd| {e:.3g}, nnz {int((d0 + beta + db0 != 0).sum())}"
              f"/{M * F}, two launches {'bit-equal' if same else 'DIFFERENT'} "
              f"-> {'ok' if ok and same else 'MISMATCH'}")
        check(ok, f"gram_cd M={M} F={F} disagrees with its plain version")
        check(same, f"gram_cd M={M} F={F}: two launches differ")
        errs["gram_cd"] = max(errs.get("gram_cd", 0.0), e)

    # blocked_cd: the modes tile (modes 0, 1, 2 at B = 16), B = 8 on it,
    # the ring at F = 256, and a B that does not divide 32 at F = 50
    for M, F, B, kind in ((16, 128, 16, "modes"), (16, 128, 8, "modes"),
                          (16, 256, 16, "modes"), (16, 50, 10, "random")):
        G, c, beta, db0, lam = tile_inputs(torch, gen, M, F, kind=kind)
        modes_out = torch.full((M, F // B), -1, dtype=torch.int32, device="cuda")
        d = blocked_cd.blocked_cd_kernel(G, c, beta, db0, lam, 1e-6, block=B,
                                         modes_out=modes_out)
        again = blocked_cd.blocked_cd_kernel(G, c, beta, db0, lam, 1e-6, block=B)
        d0 = ref.blocked_cd_ref(G, c, beta, db0, lam, 1e-6, block=B)
        modes = blocked_cycle_modes(G, B)
        torch.cuda.synchronize()
        seen = sorted(set(modes.flatten().tolist()))
        e = max_err(d, d0)
        ok = torch.allclose(d, d0, rtol=TOL, atol=TOL)
        same = torch.equal(d, again)
        print(f"[kernels] blocked_cd M={M} F={F} B={B} modes {seen}: max|dd| {e:.3g}, two "
              f"launches {'bit-equal' if same else 'DIFFERENT'} -> {'ok' if ok and same else 'MISMATCH'}")
        check_modes(torch, G, B, modes_out, modes, f"M={M} F={F} B={B}")
        if (F, B) == (128, 16):
            check(seen == [0, 1, 2], f"the modes tile should exercise modes 0, 1, 2; got {seen}")
        check(ok, f"blocked_cd F={F} B={B} disagrees with its plain version")
        check(same, f"blocked_cd F={F} B={B}: two launches differ")
        errs["blocked_cd"] = max(errs.get("blocked_cd", 0.0), e)

    # a tile exactly at the safeguard's threshold (nu = 0): ratio 0.9f, the
    # full Jacobi step; one ulp above it, the halves
    t = torch.tensor(0.9, dtype=torch.float32)
    for off, want in ((t, 0), (torch.nextafter(t, torch.tensor(1.0)), 1)):
        G = torch.tensor([[[1.0, float(off)], [float(off), 1.0]]], device="cuda")
        modes_out = torch.full((1, 1), -1, dtype=torch.int32, device="cuda")
        z = torch.zeros(1, 2, device="cuda")
        blocked_cd.blocked_cd_kernel(G, z, z, z, 0.1, 0.0, block=2, modes_out=modes_out)
        plain = int(blocked_cycle_modes(G, 2, nu=0.0)[0, 0])
        got = int(modes_out[0, 0])
        print(f"[kernels] blocked_cd threshold tile, off-diagonal {float(off)!r}: "
              f"kernel mode {got}, plain mode {plain}")
        check(got == want == plain, f"threshold tile: kernel mode {got}, plain {plain}, "
              f"expected {want}")

    # the safeguard's threshold as an argument: a tile whose modes move with
    # it, at 0.5 and 0.99
    G, c, beta, db0, lam = tile_inputs(torch, gen, 16, 128, kind="graded")
    seen = {}
    for tol in (0.5, 0.99):
        modes_out = torch.full((16, 8), -1, dtype=torch.int32, device="cuda")
        d = blocked_cd.blocked_cd_kernel(G, c, beta, db0, lam, 1e-6, block=16,
                                         modes_out=modes_out, dom_tol=tol)
        d0 = ref.blocked_cd_ref(G, c, beta, db0, lam, 1e-6, block=16, dom_tol=tol)
        modes = blocked_cycle_modes(G, 16, dom_tol=tol)
        torch.cuda.synchronize()
        e = max_err(d, d0)
        ok = torch.allclose(d, d0, rtol=TOL, atol=TOL)
        print(f"[kernels] blocked_cd dom_tol={tol} M=16 F=128 B=16 modes "
              f"{dict(Counter(modes.flatten().tolist()))}: max|dd| {e:.3g} -> "
              f"{'ok' if ok else 'MISMATCH'}")
        check_modes(torch, G, 16, modes_out, modes, f"dom_tol={tol}", dom_tol=tol)
        check(ok, f"blocked_cd at dom_tol={tol} disagrees with its plain version")
        errs["blocked_cd"] = max(errs["blocked_cd"], e)
        seen[tol] = modes
    check(not torch.equal(seen[0.5], seen[0.99]),
          "the graded tile's modes should differ between dom_tol 0.5 and 0.99")

    for F in (128, 256):
        G, c, beta, db0, lam = tile_inputs(torch, gen, 16, F)
        d1 = blocked_cd.blocked_cd_kernel(G, c, beta, db0, lam, 1e-6, block=1)
        ds = gram_cd.gram_cd_kernel(G, c, beta, db0, lam, 1e-6)
        torch.cuda.synchronize()
        same = torch.equal(d1, ds)
        print(f"[kernels] blocked_cd B=1 vs gram_cd F={F}: {'bit-equal' if same else 'DIFFERENT'}")
        check(same, f"blocked_cd at B=1 is not bit-equal to gram_cd at F={F}")

    # strided (M, F) operands, as the solve passes beta[:, sl] and dbeta[:, sl]
    G, c, beta, db0, lam = tile_inputs(torch, gen, 16, 128)
    wide_b = torch.randn(16, 4 * 128, generator=gen, device="cuda")
    wide_d = torch.randn(16, 3 * 128, generator=gen, device="cuda")
    wide_b[:, 256:384] = beta
    wide_d[:, 128:256] = db0
    vb, vd = wide_b[:, 256:384], wide_d[:, 128:256]
    for name, fn in (("gram_cd", gram_cd.gram_cd_kernel),
                     ("blocked_cd", lambda *a: blocked_cd.blocked_cd_kernel(*a, block=16))):
        same = torch.equal(fn(G, c, vb, vd, lam, 1e-6), fn(G, c, beta, db0, lam, 1e-6))
        torch.cuda.synchronize()
        print(f"[kernels] {name} on strided beta/dbeta0 views: "
              f"{'bit-equal to contiguous' if same else 'DIFFERENT'}")
        check(same, f"{name} on strided views differs from contiguous inputs")

    # the step's division (three fused multiply-adds from 1/h) against IEEE
    n_div = 2 ** 32
    bad = gram_cd.division_mismatches(n_div, seed=1)
    print(f"[kernels] tile CD division: {bad} of {n_div} pseudo-random pairs differ from "
          f"__fdiv_rn")
    check(bad == 0, f"the tile kernels' division differs from IEEE on {bad} pairs")
    return errs


def check_modes(torch, G, B: int, got, plain, label: str, dom_tol=None):
    """The kernel's modes (``modes_out``) must equal ``blocked_cycle_modes``;
    where they differ, the block's Gershgorin ratio must lie within 4 ulp
    of the threshold ``dom_tol`` (the two sum |G_jk| in different orders)."""
    from repro_torch.core.subproblem import DOM_TOL, _block_dominance

    dom_tol = DOM_TOL if dom_tol is None else dom_tol
    diff = got != plain
    if not bool(diff.any()):
        print(f"[kernels] blocked_cd {label}: in-kernel modes equal blocked_cycle_modes")
        return
    tol = torch.tensor(dom_tol, dtype=torch.float32)
    ulp = float(torch.nextafter(tol, torch.tensor(1.0)) - tol)
    rho_full = _block_dominance(G, B, 1e-6)
    near = (rho_full - dom_tol).abs() <= 4 * ulp
    if B % 2 == 0:
        rho_half = _block_dominance(G, B // 2, 1e-6).reshape(*rho_full.shape, 2).amax(-1)
        near |= (rho_half - dom_tol).abs() <= 4 * ulp
    for m, b in diff.nonzero().tolist():
        print(f"[kernels] blocked_cd {label}: block ({m}, {b}) kernel mode {int(got[m, b])}, "
              f"plain {int(plain[m, b])}, rho {float(rho_full[m, b])!r} beside {dom_tol}")
    check(bool(near[diff].all()), f"blocked_cd {label}: in-kernel modes differ from "
          f"blocked_cycle_modes away from the threshold")


def phase_main_path(torch):
    from repro_torch.analysis.sanitize import transfer_sanitizer
    from repro_torch.api import DenseDesign, LogisticL1
    from repro_torch.configs.glm import GLM_EPSILON
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.core.objective import lambda_max
    from repro_torch.data.synthetic import make_glm_dataset
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ds = make_glm_dataset(GLM_EPSILON, gen, device="cuda")
    lam = float(lambda_max(ds.X_train, ds.y_train)) / 16
    torch.cuda.synchronize()
    print(f"[main] {GLM_EPSILON.name}: X_train {tuple(ds.X_train.shape)} f32 on the card "
          f"(X {(ds.X_train.numel() + ds.X_test.numel()) * 4 / 1e9:.2f} GB in all), lam {lam:.4f}, "
          f"generated in {time.perf_counter() - t0:.2f} s")
    launches, fits, results = {}, {}, {}
    for mode in ("sequential", "blocked"):
        opts = DGLMNETOptions(num_blocks=16, tile=128, max_iters=100,
                              cycle_mode=mode, block=16)
        est = LogisticL1(opts, device="cuda")
        # warm-up: allocator pools and library handles, outside the counts
        LogisticL1(replace(opts, max_iters=1), device="cuda").fit(
            DenseDesign(ds.X_train), ds.y_train, lam)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        engine.host_syncs = 0
        t1 = time.perf_counter()
        res = est.fit(DenseDesign(ds.X_train), ds.y_train, lam)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = ops.launch_counts()
        syncs = engine.host_syncs
        # again under the transfer sanitizer, at exactly k + 1 counted reads:
        # any other read of a CUDA tensor, or any synchronising call (sync
        # debug mode "error"), fails the fit
        t2 = time.perf_counter()
        with transfer_sanitizer(max_fetches=res.n_iters + 1) as ts:
            again = est.fit(DenseDesign(ds.X_train), ds.y_train, lam)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t2
        print(f"[main] {mode}: the second fit under transfer_sanitizer(max_fetches="
              f"{res.n_iters + 1}): {ts.fetches} reads through the engine's doors, nothing "
              f"else read or synchronised; {again.n_iters} iterations")
        check(ts.fetches == res.n_iters + 1 and again.n_iters == res.n_iters
              and torch.equal(again.beta, res.beta),
              f"{mode}: the sanitized fit read {ts.fetches} times or differs from the first")
        h = res.objective_history
        tile_kernel = "gram_cd" if mode == "sequential" else "blocked_cd"
        acc = float((est.predict(ds.X_test) == ds.y_test).float().mean())
        print(f"[main] {mode}: status {res.status_name}, {res.n_iters} iters, "
              f"converged {res.converged}, f {res.f:.4f}, nnz {res.nnz}, "
              f"unit-step share {res.unit_step_frac:.2f}, test accuracy {acc:.4f}")
        print(f"[main] {mode}: fit {wall * 1e3:.1f} ms (again {wall2 * 1e3:.1f} ms), "
              f"{wall * 1e3 / res.n_iters:.2f} ms per outer iteration, host syncs {syncs}, "
              f"launches {counts}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        check(res.ok, f"{mode} fit tripped {res.status_name}")
        check(all(h[i + 1] <= h[i] + 1e-4 * abs(h[i]) for i in range(len(h) - 1)),
              f"{mode} objective history increases: {h}")
        check(bool(torch.isfinite(res.beta).all()) and res.beta.shape == (2000,),
              f"{mode} beta is not a finite (2000,) vector")
        check(counts["logistic_stats"] >= res.n_iters,
              f"{mode}: logistic_stats launched {counts['logistic_stats']} times "
              f"for {res.n_iters} iterations")
        check(counts[tile_kernel] >= res.n_iters,
              f"{mode}: {tile_kernel} launched {counts[tile_kernel]} times "
              f"for {res.n_iters} iterations")
        for name in ("logistic_stats", tile_kernel):
            launches[name] = launches.get(name, 0) + counts[name]
        fits[mode] = (wall, wall2, res.n_iters, syncs)
        results[mode] = res
    return launches, fits, ds, lam, results


def phase_agreement(torch):
    from repro_torch.api import DenseDesign, LogisticL1
    from repro_torch.configs.glm import GLM_EPSILON
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.core.objective import lambda_max
    from repro_torch.data.synthetic import make_glm_dataset

    cfg = replace(GLM_EPSILON, num_examples=10_240)      # 8192 training rows
    gen = torch.Generator(device="cuda").manual_seed(1)
    ds = make_glm_dataset(cfg, gen, device="cuda")
    lam = float(lambda_max(ds.X_train, ds.y_train)) / 16
    opts = DGLMNETOptions(num_blocks=16, tile=128, max_iters=100)
    torch.cuda.synchronize()
    engine.host_syncs = 0
    gpu, sites, stacks = under_sync_debug(torch, lambda: LogisticL1(opts, device="cuda").fit(
        DenseDesign(ds.X_train), ds.y_train, lam))
    engine_syncs = engine.host_syncs
    beta_gpu = gpu.beta.cpu()
    t0 = time.perf_counter()
    cpu = LogisticL1(opts, device="cpu").fit(
        DenseDesign(ds.X_train.cpu()), ds.y_train.cpu(), lam)
    # allow[torch-bench-timing]: times a fit on the CPU (device='cpu'); no CUDA work in between
    t_cpu = time.perf_counter() - t0
    gap = abs(gpu.f - cpu.f) / abs(cpu.f)
    close = torch.allclose(beta_gpu, cpu.beta, rtol=1e-2, atol=1e-3)
    print(f"[agree] 8192x2000: card f {gpu.f:.6f} ({gpu.n_iters} iters) vs cpu f "
          f"{cpu.f:.6f} ({cpu.n_iters} iters, {t_cpu:.1f} s): rel gap {gap:.3g}, "
          f"max|dbeta| {max_err(beta_gpu, cpu.beta):.3g}")
    print(f"[agree] card fit: {engine_syncs} host reads by the engine "
          f"({gpu.n_iters} iterations); synchronising calls seen by torch, by "
          f"call site: {dict(sites)}")
    check(gpu.ok and cpu.ok, f"agreement fits tripped: {gpu.status_name}, {cpu.status_name}")
    check(gap < 1e-4, f"card vs cpu objective gap {gap}")
    check(close, "card vs cpu betas disagree beyond rtol 1e-2 / atol 1e-3")
    check(engine_syncs == gpu.n_iters + 1,
          "the engine read the device other than once per iteration plus one fetch")
    check_sync_sites(sites, stacks, "agree")


# ---------------------------------------------------------------------------
# the sparse cell: webspam-shaped slabs made on the card
# ---------------------------------------------------------------------------

#: features of the sparse cell: webspam's 16.6M cut to 2^20 for the time limit
WEBSPAM_P = 2 ** 20
SPARSE_M = 16                          # machines, as benchmarks/table3_timing.py
SPARSE_OPTS = dict(tile=128, block=16, max_iters=100)


def slab_truth(torch, gen, p: int, density: float, dev, snr: float = 3.0):
    """The reference recipe's sparse ground truth: k_true = p // 20
    Gaussian coefficients scaled by snr / sqrt(k_true * density)."""
    k_true = max(4, p // 20)
    beta = torch.zeros(p, device=dev)
    idx = torch.randperm(p, generator=gen, device=dev)[:k_true]
    beta[idx] = torch.randn(k_true, generator=gen, device=dev) * (snr / (k_true * density) ** 0.5)
    return beta


def slab_data(torch, gen, n_rows: int, p: int, density: float, beta_true, dev):
    """(p, 1, K) by-feature slabs of an n_rows x p matrix with webspam's
    recipe drawn per feature (a dense mask cannot exist at this width):
    Binomial(n_rows, density) nonzeros per feature at distinct rows drawn
    uniformly, sorted and front-packed (sentinel n_rows), Gaussian
    values; labels from sigmoid(X beta_true) with 5% flipped. Returns
    (rows, vals, y)."""
    counts = torch.binomial(torch.full((p,), float(n_rows), device=dev),
                            torch.full((p,), float(density), device=dev), generator=gen)
    kc = int(counts.max()) + 8
    draws = torch.randint(0, n_rows, (p, kc), generator=gen, device=dev, dtype=torch.int32)
    srt, idx = torch.sort(draws, dim=1)
    dup = torch.zeros(p, kc, dtype=torch.bool, device=dev)
    dup.scatter_(1, idx[:, 1:], srt[:, 1:] == srt[:, :-1])
    del srt, idx
    # the first `count` distinct draws of each feature, in draw order: a
    # uniform subset of the rows
    rank = torch.cumsum((~dup).to(torch.int32), dim=1) - 1
    keep = torch.logical_and(~dup, rank < counts[:, None])
    rows = torch.sort(torch.where(keep, draws, n_rows), dim=1).values
    del draws, dup, rank, keep
    k = int((rows < n_rows).sum(1).max())
    rows = rows[:, :k].contiguous()
    live = rows < n_rows
    vals = torch.where(live, torch.randn(p, k, generator=gen, device=dev), 0.0)
    m = torch.zeros(n_rows, dtype=torch.float64, device=dev)
    m.index_add_(0, rows[live].long(), (vals * beta_true[:, None])[live].double())
    prob = torch.sigmoid(m.float())
    y = torch.where(torch.rand(n_rows, generator=gen, device=dev) < prob, 1.0, -1.0)
    y = torch.where(torch.rand(n_rows, generator=gen, device=dev) < 0.05, -y, y)
    return rows[:, None, :], vals[:, None, :], y


def sparse_cell(torch, dev="cuda", p: int = WEBSPAM_P, seed: int = 2):
    """GLM_WEBSPAM's example count split 80/20 as make_glm_dataset does
    (252,000 training and 63,000 test rows) at its density, p features:
    ((rows, vals, y) train, (rows, vals, y) test)."""
    from repro_torch.configs.glm import GLM_WEBSPAM

    n_test = int(GLM_WEBSPAM.num_examples * 0.2)
    n_train = GLM_WEBSPAM.num_examples - n_test
    gen = torch.Generator(device=dev).manual_seed(seed)
    beta_true = slab_truth(torch, gen, p, GLM_WEBSPAM.density, dev)
    train = slab_data(torch, gen, n_train, p, GLM_WEBSPAM.density, beta_true, dev)
    test = slab_data(torch, gen, n_test, p, GLM_WEBSPAM.density, beta_true, dev)
    return train, test


def adversarial_slab(torch, gen, B: int = 4, t: int = 128, k: int = 40, n: int = 5000):
    """(B, t, k) slab with duplicate rows within features, sentinels
    anywhere (several values >= n) carrying nonzero values, empty
    features, and each feature's slots in random order."""
    dev = "cuda"
    rows = torch.randint(0, n, (B, t, k), generator=gen, device=dev, dtype=torch.int32)
    rows[:, :, 1] = rows[:, :, 0]
    rows[:, 2, :] = rows[:, 2, :1]
    sent = torch.rand(B, t, k, generator=gen, device=dev) < 0.3
    rows = torch.where(sent, n + torch.randint(0, 3, (B, t, k), generator=gen, device=dev,
                                               dtype=torch.int32), rows)
    rows[:, 4] = n
    rows[:, -1] = n + 7
    vals = torch.randn(B, t, k, generator=gen, device=dev)
    vals[:, 4] = 5.0
    shuffle = torch.argsort(torch.rand(B, t, k, generator=gen, device=dev), dim=-1)
    return rows.gather(-1, shuffle), vals.gather(-1, shuffle)


def phase_sparse_kernels(torch, gen, cell):
    """slab_gram and slab_spmv against their plain versions at the cell's
    shapes and on adversarial slabs; two launches bit-equal. Returns the
    errors and the inputs the times phase reuses."""
    from repro_torch.core.distributed import layout_slabs
    from repro_torch.kernels import ops, ref
    slab_gram = import_module("repro_torch.kernels.slab_gram")
    slab_spmv = import_module("repro_torch.kernels.slab_spmv")
    from repro_torch.kernels.slab_spmv import SlabOrder, slab_order

    (rows, vals, y), _ = cell
    n, p, K = y.shape[0], rows.shape[0], rows.shape[-1]
    M, T = SPARSE_M, SPARSE_OPTS["tile"]
    lay = layout_slabs(rows[:, 0], vals[:, 0], M, T)
    t = lay.rows.shape[1] // 2                      # a tile step in the middle
    R, V = lay.rows[:, t], lay.vals[:, t]
    w = 0.05 + 0.2 * torch.rand(n, generator=gen, device="cuda")
    r = torch.randn(M, n, generator=gen, device="cuda")
    d = 0.1 * torch.randn(M, T, generator=gen, device="cuda")
    order = SlabOrder(*(f[:, t] for f in lay.order))
    errs = {"slab_gram": 0.0, "slab_spmv": 0.0}

    def hold(name, label, got, plain, oracle=None, again=None):
        e = max(max_err(a, b) for a, b in zip(got, plain))
        ok = all(torch.allclose(a, b, rtol=TOL, atol=TOL) for a, b in zip(got, plain))
        if oracle is not None:
            e = max(e, max(max_err(a, b) for a, b in zip(got, oracle)))
            ok = ok and all(torch.allclose(a, b, rtol=TOL, atol=TOL) for a, b in zip(got, oracle))
        same = again is None or all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"[sparse-kernels] {name} {label}: max abs err {e:.3g}"
              f"{'' if again is None else ', two launches ' + ('bit-equal' if same else 'DIFFERENT')}"
              f" -> {'ok' if ok and same else 'MISMATCH'}")
        check(ok, f"{name} {label} disagrees with its plain version")
        check(same, f"{name} {label}: two launches differ")
        errs[name] = max(errs[name], e)

    # slab_gram at a tile step of the cell: (M, T, K) with sorted slots and
    # the tile's row-sorted order, as the solve calls it; the kernel
    # gathers its operands itself, the plain path's gathers feed the join
    safe, va, wv, cva = ops._sentinel_zeroed(R, V, w, r, n)
    live = R < n
    dup = bool((live[..., 1:] & (R[..., 1:] == R[..., :-1])).any())
    check(not dup, "the cell's tile should have no duplicate rows within a feature")
    got = slab_gram.slab_gram_kernel(R, V, w, r, rows_sorted=True, order=order)
    again = slab_gram.slab_gram_kernel(R, V, w, r, rows_sorted=True, order=order)
    plain = ref.slab_gram_join(safe, wv, va, cva)
    torch.cuda.synchronize()
    hold("slab_gram", f"cell tile M={M} T={T} K={K} (gathers fused, no duplicates)", got,
         plain, oracle=ref.slab_gram_ref(R, V, w, r), again=again)
    # the order the wrapper builds (for callers that pass none) gives the same
    built = slab_gram.slab_gram_kernel(R, V, w, r, rows_sorted=True)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, built)),
          "slab_gram with its own order differs from slab_gram with the layout's")
    del safe, va, wv, cva, live, built
    # slab_spmv at the same tile step: r -= X_F d for every block at once
    got = slab_spmv.slab_spmv_kernel(order, V, d, r.clone(), n_loc=n, sign=-1.0)
    again = slab_spmv.slab_spmv_kernel(order, V, d, r.clone(), n_loc=n, sign=-1.0)
    dv = torch.where(R < n, V, 0.0) * d[..., None]
    plain = r - ref.slab_spmv_scatter(R.clamp_max(n), dv, n)
    hold("slab_spmv", f"cell residual update M={M} T={T} K={K}", (got,), (plain,),
         oracle=(r - ref.slab_spmv_ref(R, V, d, n),), again=(again,))
    # the tile step's call: dbeta[:, sl] += d fused into the same launch
    dbw = torch.randn(M, 3 * T, generator=gen, device="cuda")
    fused_r, fused_db = r.clone(), dbw.clone()
    slab_spmv.slab_spmv_kernel(order, V, d, fused_r, n_loc=n, sign=-1.0,
                               dbeta=fused_db[:, T:2 * T])
    sep_db = dbw.clone()
    sep_db[:, T:2 * T] += d
    torch.cuda.synchronize()
    same = torch.equal(fused_r, got) and torch.equal(fused_db, sep_db)
    print(f"[sparse-kernels] slab_spmv with dbeta fused: r and dbeta "
          f"{'bit-equal' if same else 'DIFFERENT'} to the separate launch and += -> "
          f"{'ok' if same else 'MISMATCH'}")
    check(same, "slab_spmv with the dbeta update fused differs from the separate steps")
    # the dispatch's own order (order=None) against the layout's
    built_m = ops.slab_spmv(R, V, d, n_loc=n)
    passed_m = ops.slab_spmv(R, V, d, n_loc=n, order=order)
    built_r = ops.slab_residual_update(r.clone(), R, V, d)
    torch.cuda.synchronize()
    same = torch.equal(built_m, passed_m) and torch.equal(built_r, got)
    print(f"[sparse-kernels] slab_spmv with order=None: "
          f"{'bit-equal' if same else 'DIFFERENT'} to the layout's order -> "
          f"{'ok' if same else 'MISMATCH'}")
    check(same, "slab_spmv with the order built per call differs from the layout's order")
    # an order without its values is refused before any launch
    before = slab_spmv.launches
    try:
        slab_spmv.slab_spmv_kernel(SlabOrder(order.rows_s, order.perm), V, d, r.clone(),
                                   n_loc=n, sign=-1.0)
        refused = False
    except ValueError:
        refused = True
    print(f"[sparse-kernels] slab_spmv with an order lacking vals_s: "
          f"{'refused' if refused else 'LAUNCHED'} -> {'ok' if refused else 'MISMATCH'}")
    check(refused and slab_spmv.launches == before,
          "slab_spmv accepted an order without its values")
    del dbw, fused_r, fused_db, sep_db, built_m, passed_m, built_r
    # slab_spmv at the margins' shape: (M, p/M, K) per block
    Rm, Vm = rows[:, 0].reshape(M, p // M, K), vals[:, 0].reshape(M, p // M, K)
    beta = torch.randn(M, p // M, generator=gen, device="cuda")
    om = slab_order(Rm, Vm)
    got = slab_spmv.slab_spmv_kernel(om, Vm, beta, torch.zeros(M, n, device="cuda"),
                                     n_loc=n, sign=1.0)
    again = slab_spmv.slab_spmv_kernel(om, Vm, beta, torch.zeros(M, n, device="cuda"),
                                       n_loc=n, sign=1.0)
    dvm = torch.where(Rm < n, Vm, 0.0) * beta[..., None]
    hold("slab_spmv", f"cell margins M={M} p/M={p // M} K={K}", (got,),
         (ref.slab_spmv_scatter(Rm.clamp_max(n), dvm, n),), again=(again,))
    del om, dvm
    # adversarial slabs, through the dispatch (slots unsorted: the
    # wrapper sorts them; the order is built per call)
    ra, vla = adversarial_slab(torch, gen)
    na = 5000
    wa = 0.05 + 0.2 * torch.rand(na, generator=gen, device="cuda")
    rra = torch.randn(ra.shape[0], na, generator=gen, device="cuda")
    da = torch.randn(ra.shape[0], ra.shape[1], generator=gen, device="cuda")
    sa = ops._sentinel_zeroed(ra, vla, wa, rra, na)
    got = ops.slab_gram(ra, vla, wa, rra)
    again = ops.slab_gram(ra, vla, wa, rra)
    hold("slab_gram", "adversarial (duplicates, sentinels with values, empty, unsorted)",
         got, ref.slab_gram_join(sa[0], sa[2], sa[1], sa[3]),
         oracle=ref.slab_gram_ref(ra, vla, wa, rra), again=again)
    # a tile whose row-sorted order does not fit in shared memory (the
    # kernel keeps it in global scratch), duplicate rows and sentinels
    nw = 20_000
    rw = torch.sort(torch.randint(0, nw, (3, 96, 300), generator=gen, device="cuda",
                                  dtype=torch.int32), dim=-1).values
    rw[..., -3:] = nw
    vw = torch.randn(3, 96, 300, generator=gen, device="cuda")
    ww = 0.05 + 0.2 * torch.rand(nw, generator=gen, device="cuda")
    rrw = torch.randn(3, nw, generator=gen, device="cuda")
    check(slab_gram._scratch_ints(3, 96, 300) > 0, "the wide tile should take the scratch path")
    sw = ops._sentinel_zeroed(rw, vw, ww, rrw, nw)
    got = ops.slab_gram(rw, vw, ww, rrw, rows_sorted=True)
    again = ops.slab_gram(rw, vw, ww, rrw, rows_sorted=True)
    hold("slab_gram", "wide tile T=96 K=300 (order in global scratch, duplicates)", got,
         ref.slab_gram_join(sw[0], sw[2], sw[1], sw[3]),
         oracle=ref.slab_gram_ref(rw, vw, ww, rrw), again=again)
    del rw, vw, ww, rrw, sw
    got = ops.slab_spmv(ra, vla, da, n_loc=na)
    again = ops.slab_spmv(ra, vla, da, n_loc=na)
    dva = torch.where(ra < na, vla, 0.0) * da[..., None]
    hold("slab_spmv", "adversarial (duplicates, sentinels with values, empty, unsorted)",
         (got,), (ref.slab_spmv_scatter(ra.clamp_max(na), dva, na),),
         oracle=(ref.slab_spmv_ref(ra, vla, da, na),), again=(again,))
    got = ops.slab_residual_update(rra.clone(), ra, vla, da)
    hold("slab_spmv", "adversarial residual update", (got,),
         (rra - ref.slab_spmv_scatter(ra.clamp_max(na), dva, na),))
    # a hub row: example 17 in the first 9 slots of every feature (1,152
    # slots per block, a run across warps and 512-position blocks)
    rh = torch.sort(torch.randint(0, na, (4, 128, 94), generator=gen, device="cuda",
                                  dtype=torch.int32), dim=-1).values
    rh[..., :9] = 17
    vh = torch.randn(4, 128, 94, generator=gen, device="cuda")
    dh = 0.1 * torch.randn(4, 128, generator=gen, device="cuda")
    oh = slab_order(rh, vh)
    check(int((oh.rows_s == 17).sum(-1).min()) >= 2 * slab_spmv.CHUNK,
          "the hub row's run should cross two blocks")
    got = ops.slab_residual_update(rra[:4].clone(), rh, vh, dh, order=oh)
    again = ops.slab_residual_update(rra[:4].clone(), rh, vh, dh, order=oh)
    dvh = vh * dh[..., None]
    hold("slab_spmv", "hub row across warps and blocks", (got,),
         (rra[:4] - ref.slab_spmv_scatter(rh, dvh, na),),
         oracle=(rra[:4] - ref.slab_spmv_ref(rh, vh, dh, na),), again=(again,))
    del rh, vh, dh, oh, dvh
    # the path's restricted solves: slabs gathered at a working set's K
    # class (8 ... 94, front-packed slots trimmed) and, at the smallest
    # capacity M * T, laid out by layout_slabs into one tile per block
    for kc in (8, 16, 32, 64, K):
        lay1 = layout_slabs(rows[:M * T, 0, :kc], vals[:M * T, 0, :kc], M, T)
        check(lay1.rows.shape[1] == 1, "a capacity of M * tile should be one tile per block")
        R1, V1 = lay1.rows[:, 0], lay1.vals[:, 0]
        o1 = SlabOrder(*(f[:, 0] for f in lay1.order))
        s1 = ops._sentinel_zeroed(R1, V1, w, r, n)
        got = slab_gram.slab_gram_kernel(R1, V1, w, r, rows_sorted=True, order=o1)
        again = slab_gram.slab_gram_kernel(R1, V1, w, r, rows_sorted=True, order=o1)
        hold("slab_gram", f"path K class {kc}, one tile per block (M={M} T={T})", got,
             ref.slab_gram_join(s1[0], s1[2], s1[1], s1[3]), again=again)
        got = slab_spmv.slab_spmv_kernel(o1, V1, d, r.clone(), n_loc=n, sign=-1.0)
        again = slab_spmv.slab_spmv_kernel(o1, V1, d, r.clone(), n_loc=n, sign=-1.0)
        dv1 = torch.where(R1 < n, V1, 0.0) * d[..., None]
        hold("slab_spmv", f"path K class {kc}, residual update, one tile per block", (got,),
             (r - ref.slab_spmv_scatter(R1.clamp_max(n), dv1, n),), again=(again,))
        del lay1, R1, V1, o1, s1, dv1
    inputs = dict(R=R, V=V, w=w, r=r, d=d, order=order, n=n, margins=(Rm, Vm, beta))
    del lay
    errs["slab_path_spmv"], inputs["serve"] = path_spmv_checks(torch, gen, ra, vla, na)
    return errs, inputs


#: the serve phase's batch: max_batch requests of 1 ... SERVE_TOKENS tokens
SERVE_BATCH = 256
SERVE_TOKENS = 376
SERVE_K = 8                             # the request slab's K class (k_capacity's floor)
SERVE_PATH_LEN = 8


def serve_slab(torch, gen, B: int, T: int, K: int, n_loc: int, live: float):
    """A request slab (B, T, K) as ``serve.pack_requests`` makes one:
    each slot live with probability ``live`` at a uniform request row,
    front-packed and row-sorted per feature (sentinel n_loc)."""
    rows = torch.randint(0, n_loc, (B, T, K), generator=gen, device="cuda",
                         dtype=torch.int32)
    keep = torch.rand(B, T, K, generator=gen, device="cuda") < live
    rows = torch.sort(torch.where(keep, rows, n_loc), dim=-1).values
    vals = torch.where(rows < n_loc, torch.randn(B, T, K, generator=gen, device="cuda"), 0.0)
    return rows, vals


def path_spmv_checks(torch, gen, ra, vla, na):
    """``slab_spmv``'s path mode (``ops.slab_path_spmv``) against its plain
    version at the serve phase's shapes, a local store's (1, 2^20, 8) and a
    (1, 16) mesh store's (16, 65,536, 8), and on the adversarial and hub
    slabs, with random ``lam_idx`` over L = 8; at a uniform ``lam_idx ==
    l`` bit-equal to ``slab_spmv`` with ``betas[l]`` for every l; two
    launches bit-equal. Returns the largest error and the two serve
    shapes' inputs for the times phase."""
    from repro_torch.kernels import ref
    slab_spmv = import_module("repro_torch.kernels.slab_spmv")
    from repro_torch.kernels.slab_spmv import slab_order

    L, err = SERVE_PATH_LEN, 0.0
    # about SERVE_BATCH * SERVE_TOKENS / 2 live slots, as a served batch
    live = SERVE_BATCH * (SERVE_TOKENS + 1) / 2 / (WEBSPAM_P * SERVE_K)
    cases = []
    for B, T in ((1, WEBSPAM_P), (SPARSE_M, WEBSPAM_P // SPARSE_M)):
        rows, vals = serve_slab(torch, gen, B, T, SERVE_K, SERVE_BATCH, live)
        cases.append((f"serve shape {B} x {T} x {SERVE_K}", rows, vals, SERVE_BATCH))
    cases.append(("adversarial (duplicates, sentinels with values, empty, unsorted)",
                  ra, vla, na))
    rh = torch.sort(torch.randint(0, na, (4, 128, 94), generator=gen, device="cuda",
                                  dtype=torch.int32), dim=-1).values
    rh[..., :9] = 17
    cases.append(("hub row across warps and blocks", rh,
                  torch.randn(4, 128, 94, generator=gen, device="cuda"), na))
    inputs = []
    for label, rows, vals, n_loc in cases:
        B, T, K = rows.shape
        betas = torch.randn(L, B, T, generator=gen, device="cuda")
        lam_idx = torch.randint(0, L, (n_loc,), generator=gen, device="cuda",
                                dtype=torch.int32)
        order = slab_order(rows, vals)
        zeros = lambda: torch.zeros(B, n_loc, device="cuda")  # noqa: E731
        got = slab_spmv.slab_path_spmv_kernel(order, vals, lam_idx, betas, zeros(),
                                              n_loc=n_loc)
        again = slab_spmv.slab_path_spmv_kernel(order, vals, lam_idx, betas, zeros(),
                                                n_loc=n_loc)
        plain = ref.slab_path_spmv_scatter(rows, vals, lam_idx, betas, n_loc)
        torch.cuda.synchronize()
        e = max_err(got, plain)
        ok = torch.allclose(got, plain, rtol=TOL, atol=TOL)
        same = torch.equal(got, again)
        uniform = []
        for l in range(L):
            u = slab_spmv.slab_path_spmv_kernel(
                order, vals, torch.full((n_loc,), l, dtype=torch.int32, device="cuda"),
                betas, zeros(), n_loc=n_loc)
            m = slab_spmv.slab_spmv_kernel(order, vals, betas[l], zeros(), n_loc=n_loc,
                                           sign=1.0)
            uniform.append(torch.equal(u, m))
        torch.cuda.synchronize()
        print(f"[sparse-kernels] slab_spmv path mode {label}, L={L}, random lam_idx: max abs "
              f"err {e:.3g}, two launches {'bit-equal' if same else 'DIFFERENT'}; uniform "
              f"lam_idx bit-equal to slab_spmv with betas[l] for l = 0..{L - 1}: {uniform} -> "
              f"{'ok' if ok and same and all(uniform) else 'MISMATCH'}")
        check(ok, f"slab_spmv path mode {label} disagrees with its plain version")
        check(same, f"slab_spmv path mode {label}: two launches differ")
        check(all(uniform), f"slab_spmv path mode {label}: a uniform lambda is not bit-equal "
              f"to slab_spmv")
        err = max(err, e)
        if label.startswith("serve shape"):
            inputs.append(dict(rows=rows, vals=vals, order=order, lam_idx=lam_idx,
                               betas=betas, n_loc=n_loc))
    return err, inputs


def phase_sparse_path(torch, cell, card):
    """The by-feature slab solve of the cell on a (1, 16) mesh, both cycle
    modes."""
    from repro_torch.api import LogisticL1, SlabDesign, as_design, lambda_max_design, resolve
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh

    (rows, vals, y), (rt, vt, yt) = cell
    n, p, K = y.shape[0], rows.shape[0], rows.shape[-1]
    design = SlabDesign(rows, vals, n)
    test = SlabDesign(rt, vt, yt.shape[0])
    nnz = int((rows < n).sum())
    lam = float(lambda_max_design(design, y)) / 16
    mesh = make_dev_mesh(1, SPARSE_M)
    steps = p // (SPARSE_M * SPARSE_OPTS["tile"])
    print(f"[sparse] webspam-shaped slabs: n_train {n}, n_test {yt.shape[0]}, p {p}, "
          f"K {K}, nnz {nnz} ({nnz / p:.1f} per feature), "
          f"{(rows.numel() + vals.numel()) * 4 / 1e9:.2f} GB of training slabs; lam {lam:.4f}; "
          f"M={SPARSE_M}, {steps} tile steps per outer iteration")
    launches, fits = {}, {}
    for mode in ("sequential", "blocked"):
        opts = DGLMNETOptions(cycle_mode=mode, **SPARSE_OPTS)
        strat = resolve(as_design(design, mesh=mesh, tile=opts.tile), opts)
        dense = strat.use_densify(n, K)
        print(f"[sparse] {mode}: strategy execution={strat.execution} solver={strat.solver} "
              f"densify={dense} (prefer_slab_gram({n}, {K}) = {ops.prefer_slab_gram(n, K)})")
        check(strat.execution == "mesh" and strat.solver == "slab" and not dense,
              f"the strategy did not pick the slab-native solver: {strat}, densify={dense}")
        est = LogisticL1(opts, mesh=mesh, device="cuda")
        # warm-up: allocator pools, outside the counts
        LogisticL1(replace(opts, max_iters=1), mesh=mesh, device="cuda").fit(design, y, lam)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        engine.host_syncs = 0
        t1 = time.perf_counter()
        res = est.fit(design, y, lam)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = ops.launch_counts()
        syncs = engine.host_syncs
        peak = torch.cuda.max_memory_allocated() / 1e9
        h = res.objective_history
        tile_kernel = "gram_cd" if mode == "sequential" else "blocked_cd"
        scores = est.decision_function(test)
        acc = float((torch.where(scores >= 0, 1.0, -1.0) == yt).float().mean())
        print(f"[sparse] {mode}: status {res.status_name}, {res.n_iters} iters, converged "
              f"{res.converged}, f {res.f:.4f}, nnz {res.nnz}, unit-step share "
              f"{res.unit_step_frac:.2f}, held-out accuracy {acc:.4f} ({yt.shape[0]} test rows)")
        print(f"[sparse] {mode}: fit {wall:.3f} s, {wall * 1e3 / res.n_iters:.2f} ms per outer "
              f"iteration, host syncs {syncs}, launches {counts}, peak device memory "
              f"{peak:.2f} GB, on {card}")
        check(res.ok, f"sparse {mode} fit tripped {res.status_name}")
        check(all(h[i + 1] <= h[i] + 1e-4 * abs(h[i]) for i in range(len(h) - 1)),
              f"sparse {mode} objective history increases: {h}")
        check(bool(torch.isfinite(res.beta).all()) and res.beta.shape == (p,),
              f"sparse {mode} beta is not a finite ({p},) vector")
        check(bool(torch.isfinite(scores).all()) and scores.shape == (yt.shape[0],),
              f"sparse {mode} scores are not finite ({yt.shape[0]},)")
        for name in ("slab_gram", "slab_spmv", "logistic_stats", tile_kernel):
            check(counts[name] >= res.n_iters,
                  f"sparse {mode}: {name} launched {counts[name]} times for "
                  f"{res.n_iters} iterations")
            launches[name] = launches.get(name, 0) + counts[name]
        check(syncs == res.n_iters + 2,
              f"sparse {mode}: {syncs} host reads, expected {res.n_iters} iterations + 1 "
              f"fetch + 1 entry read")
        check(acc > 0.5, f"sparse {mode}: held-out accuracy {acc} is not above chance")
        print(f"[sparse] {mode}: bits (sha256) of beta {digest(torch, res.beta)}, history "
              f"{digest(torch, h)}, scores {digest(torch, scores)}")
        fits[mode] = (wall, res.n_iters, syncs, peak, res.f, res.beta, res.objective_history)
    return launches, fits, lam


def phase_sparse_agreement(torch):
    """An 8192 x 4096 slab fit on the card against the CPU, slab-native and
    densify-once: converged fits to a relative objective gap < 1e-4, and
    fits of a fixed 8 iterations (rel_tol = 0, so both sides take the same
    steps and only rounding separates them) to the gap and betas within
    rtol 1e-2 / atol 1e-3. Converged fits are not compared by beta: the
    stopping rule can end the two sides on different iterations of a
    slow tail."""
    from repro_torch.api import LogisticL1, SlabDesign, lambda_max_design
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.kernels.ops import prefer_slab_gram
    from repro_torch.launch.mesh import make_dev_mesh

    n, p, density = 8192, 4096, 0.0015
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, vals, y = slab_data(torch, gen, n, p, density,
                              slab_truth(torch, gen, p, density, "cuda"), "cuda")
    K = rows.shape[-1]
    check(prefer_slab_gram(n, K), f"agreement slabs too dense: K={K} at n={n}")
    design = SlabDesign(rows, vals, n)
    lam = float(lambda_max_design(design, y)) / 16
    opts = DGLMNETOptions(**SPARSE_OPTS)
    mesh, cpu_mesh = make_dev_mesh(1, SPARSE_M), make_dev_mesh(1, SPARSE_M, device="cpu")
    cpu_design, y_cpu = design.to("cpu"), y.cpu()
    torch.cuda.synchronize()
    engine.host_syncs = 0
    gpu, sites, stacks = under_sync_debug(
        torch, lambda: LogisticL1(opts, mesh=mesh, device="cuda").fit(design, y, lam))
    engine_syncs = engine.host_syncs
    print(f"[sparse-agree] card slab-native fit: {engine_syncs} host reads through the "
          f"engine ({gpu.n_iters} iterations + 1 fetch + 1 entry read); synchronising "
          f"calls seen by torch, by call site: {dict(sites)}")
    check(engine_syncs == gpu.n_iters + 2,
          "the slab fit read the device other than once per iteration, one fetch "
          "and one entry read")
    check_sync_sites(sites, stacks, "sparse-agree")
    fixed = replace(opts, max_iters=8, rel_tol=0.0)
    for densify in (None, True):
        label = "densify-once" if densify else "slab-native"
        for o in (opts, fixed):
            if densify or o is fixed:
                gpu = LogisticL1(o, mesh=mesh, device="cuda").fit(design, y, lam,
                                                                  densify=densify)
            t0 = time.perf_counter()
            cpu = LogisticL1(o, mesh=cpu_mesh, device="cpu").fit(cpu_design, y_cpu, lam,
                                                                 densify=densify)
            # allow[torch-bench-timing]: times a fit on the CPU (device='cpu'); no CUDA work in between
            t_cpu = time.perf_counter() - t0
            beta_gpu = gpu.beta.cpu()
            gap = abs(gpu.f - cpu.f) / abs(cpu.f)
            run = "fixed 8 iterations" if o is fixed else "converged"
            print(f"[sparse-agree] {n}x{p} K={K} {label}, {run}: card f {gpu.f:.6f} "
                  f"({gpu.n_iters} iters) vs cpu f {cpu.f:.6f} ({cpu.n_iters} iters, "
                  f"{t_cpu:.1f} s): rel gap {gap:.3g}, max|dbeta| "
                  f"{max_err(beta_gpu, cpu.beta):.3g}")
            check(gpu.ok and cpu.ok, f"{label} {run} agreement fits tripped: "
                  f"{gpu.status_name}, {cpu.status_name}")
            check(gap < 1e-4, f"{label} {run}: card vs cpu objective gap {gap}")
            if o is fixed:
                check(gpu.n_iters == cpu.n_iters == 8,
                      f"{label}: fixed runs took {gpu.n_iters} and {cpu.n_iters} iterations")
                check(torch.allclose(beta_gpu, cpu.beta, rtol=1e-2, atol=1e-3),
                      f"{label}: card vs cpu betas after 8 iterations disagree beyond "
                      f"rtol 1e-2 / atol 1e-3")


# ---------------------------------------------------------------------------
# the screened regularization path (paper Algorithm 5) on the sparse cell
# ---------------------------------------------------------------------------

#: grid points of the path phase: lambda_max / 2 ... lambda_max / 256
PATH_LEN = 8
#: index of lambda_max / 16 on the grid, the lambda of the sparse path phase's fit
PATH_DIRECT = 3
#: budget of the sanitized two-point head; the run is held to its exact
#: count from its own telemetry
HEAD_READS_MAX = 10_000
KKT_TOL = 1e-3
MAX_KKT_ROUNDS = 8


class PathLog:
    """Wraps the estimator's ``_solve`` and ``_screened_point`` for one
    run (``with``): each restricted solve's host reads, iterations,
    status, capacity, slab K and wall, and each point's certified working
    set (on the driver's work axis)."""

    def __init__(self):
        from repro_torch.api import estimator
        from repro_torch.core import engine

        self.mod, self.engine = estimator, engine
        self.real = (estimator._solve, estimator._screened_point)
        self.rows, self.masks = [], []

    def __enter__(self):
        solve_fn, point_fn = self.real

        def solve(design, y, lam, strat, **kw):
            s0, t0 = self.engine.host_syncs, time.perf_counter()
            res = solve_fn(design, y, lam, strat, **kw)
            self.rows.append(dict(lam=lam, reads=self.engine.host_syncs - s0,
                                  iters=res.n_iters, status=res.status,
                                  cap=design.shape[1], k=getattr(design.inner, "k", None),
                                  # allow[torch-bench-timing]: a solve ends in the engine's counted fetch, which waits for its work
                                  ms=(time.perf_counter() - t0) * 1e3))
            return res

        def point(*args, **kw):
            out = point_fn(*args, **kw)
            self.masks.append(out[4])
            return out

        self.mod._solve, self.mod._screened_point = solve, point
        return self

    def __exit__(self, *exc):
        self.mod._solve, self.mod._screened_point = self.real


class TimedEval:
    """An ``eval_fn`` that also keeps each call's host clock span and
    counts its host reads (the per-point walls are the gaps between
    calls)."""

    def __init__(self, fn):
        from repro_torch.core import engine

        self.fn, self.engine, self.marks, self.reads = fn, engine, [], 0

    def __call__(self, beta):
        t0, s0 = time.perf_counter(), self.engine.host_syncs
        out = self.fn(beta)
        self.reads += self.engine.host_syncs - s0
        # allow[torch-bench-timing]: the eval ends in a counted host read of its scores
        self.marks.append((t0, time.perf_counter()))
        return out


#: the path driver's phases under a ``path`` span (the reference's span
#: names); ``bucket_stream`` spans nest inside the others, so the totals
#: overlap where a phase streams
PATH_PHASES = ("lambda_grid", "screen_round", "restricted_solve", "kkt_check", "point_finish",
               "bucket_stream")


def path_splits(spans) -> list:
    """For each traced ``path`` root among ``spans`` (one tracer's records),
    in order: its wall, the walls of its direct children, the total ms and
    count of each of PATH_PHASES beneath it, the time of each
    ``lambda_point`` outside its child spans (the strong rule's screen
    pass and its gathers run there) and the root's time outside its
    children (design wrap, residency build, strategy). Asynchronous work
    is timed in the span that owns the next host read."""
    kids = {}
    for r in spans:
        kids.setdefault(r["parent"], []).append(r)

    def below(r):
        for c in kids.get(r["sid"], ()):
            yield c
            yield from below(c)

    out = []
    for root in sorted((r for r in spans if r["parent"] is None and r["name"] == "path"),
                       key=lambda r: r["ts"]):
        children = sorted(kids.get(root["sid"], ()), key=lambda r: r["ts"])
        under = list(below(root))
        points = [c for c in children if c["name"] == "lambda_point"]
        out.append(dict(
            wall_ms=root["dur"] * 1e3,
            children=[(c["name"], c["args"].get("index"), c["dur"] * 1e3) for c in children],
            phases={name: sum(r["dur"] for r in under if r["name"] == name) * 1e3
                    for name in PATH_PHASES},
            counts={name: sum(1 for r in under if r["name"] == name) for name in PATH_PHASES},
            point_other_ms=sum(c["dur"] - sum(k["dur"] for k in kids.get(c["sid"], ()))
                               for c in points) * 1e3,
            setup_ms=(root["dur"] - sum(c["dur"] for c in children)) * 1e3))
    return out


def split_line(split) -> str:
    """One line of a :func:`path_splits` entry."""
    kids = ", ".join(f"{name}{'' if i is None else f'[{i}]'} {ms:.1f}"
                     for name, i, ms in split["children"])
    phases = ", ".join(f"{name} {split['phases'][name]:.1f} ms ({split['counts'][name]})"
                       for name in PATH_PHASES)
    return (f"path {split['wall_ms']:.1f} ms; direct children (ms): {kids}; phases: {phases}; "
            f"lambda_point outside its spans {split['point_other_ms']:.1f} ms; path outside "
            f"its children {split['setup_ms']:.1f} ms")


def driver_reads(res, n_solves: int, slab_mesh: bool = True) -> int:
    """The path driver's host reads, from its telemetry: lambda_max; per
    point the final count and (nnz, f); per KKT round the working-set and
    violation counts, and for each round that admitted violators under
    the budget the budget's and the admitted count; per restricted solve
    of a front-packed slab mesh its K class."""
    total = 1
    for s in res.screen:
        R = s["kkt_rounds"]
        total += 2 + 2 * R + 2 * sum(1 for r in range(1, R) if r < MAX_KKT_ROUNDS - 1)
    return total + (n_solves if slab_mesh else 0)


def kkt_recheck(torch, rows, vals, y, beta, lam: float, working):
    """An independent KKT pass at ``beta``: margins by the plain scatter,
    |g| by the plain ``slab_corr``. Returns, for the features with
    beta_j = 0 outside the point's certified working set ``working`` (the
    ones the screen discarded) and inside it, the count with |g_j| > lam
    (1 + KKT_TOL) + 1e-7 and the largest |g_j| / lam."""
    from repro_torch.kernels import ops, ref

    n = y.shape[0]
    r2, v2 = rows[:, 0], vals[:, 0]
    m = ref.slab_spmv_scatter(r2.clamp_max(n), torch.where(r2 < n, v2, 0.0) * beta[:, None],
                              n)
    g = ops.slab_corr(r2, v2, torch.sigmoid(m) - (y + 1.0) * 0.5).abs()
    over = g > lam * (1.0 + KKT_TOL) + 1e-7
    out = []
    for part in (torch.logical_and(beta == 0, ~working), torch.logical_and(beta == 0, working)):
        out.append((int((over & part).sum()),
                    float(torch.where(part, g, 0.0).max()) / lam))
    return out


def phase_path(torch, cell, card, direct):
    """``LogisticL1.path`` on the cell at full width, a (1, 16) mesh, both
    cycle modes; ``direct`` maps a mode to the sparse path phase's fit
    (lam, f, beta) at lambda_max / 16."""
    from repro_torch.analysis.sanitize import compile_sanitizer, transfer_sanitizer
    from repro_torch.api import (LogisticL1, ShardedDesign, SlabDesign, lambda_max_design,
                                 make_design_eval)
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh

    (rows, vals, y), (rt, vt, yt) = cell
    n, p = y.shape[0], rows.shape[0]
    mesh = make_dev_mesh(1, SPARSE_M)
    design = SlabDesign(rows, vals, n)
    lmax = float(lambda_max_design(design, y))
    sharded = ShardedDesign(design, mesh, tile=SPARSE_OPTS["tile"])
    m0 = torch.zeros(n, device="cuda")
    screen_ms = time_ms(torch, lambda: sharded._screen_abs_work(y, m0),
                        torch.empty(1, device="cuda"), reps=10)
    print(f"[path] one screen pass over p = {p} (|X^T v| through slab_corr, in chunks): "
          f"{screen_ms:.3f} ms (CUDA events, median of 10), on {card}")
    del sharded
    launches, walls = {}, {}
    for mode in ("sequential", "blocked"):
        opts = DGLMNETOptions(cycle_mode=mode, **SPARSE_OPTS)
        tile_kernel = "gram_cd" if mode == "sequential" else "blocked_cd"
        # the first two points under the transfer sanitizer (sync debug mode
        # "error" outside the engine's counted doors; every other read of a
        # CUDA tensor raises): the reads must be the driver's and the solves'
        def sanitized_head():
            with PathLog() as hlog, transfer_sanitizer(max_fetches=HEAD_READS_MAX) as ts:
                out = LogisticL1(opts, mesh=mesh, device="cuda").path(design, y, path_len=2)
            return out, ts.fetches, hlog.rows

        (head, head_reads, head_solves), sites, stacks = under_sync_debug(torch, sanitized_head)
        head_want = (driver_reads(head, len(head_solves))
                     + sum(s["reads"] for s in head_solves))
        print(f"[path] {mode}: first two points under transfer_sanitizer: f {list(head.f)}; "
              f"{head_reads} reads through the engine's doors (the driver's "
              f"{driver_reads(head, len(head_solves))} + {len(head_solves)} solves' "
              f"{head_want - driver_reads(head, len(head_solves))}); other synchronising "
              f"calls: {dict(sites)}")
        check_sync_sites(sites, stacks, f"path {mode}")
        check(head_reads == head_want, f"path {mode}: the sanitized head read {head_reads} "
              f"times, expected {head_want}")
        evals = TimedEval(make_design_eval(SlabDesign(rt, vt, yt.shape[0]), yt, mesh=mesh,
                                           tile=opts.tile))
        est = LogisticL1(opts, mesh=mesh, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        engine.host_syncs = 0
        # the second mode's path runs warm: zero kernel builds or first loads
        builds = compile_sanitizer(0) if mode == "blocked" else contextlib.nullcontext()
        with PathLog() as log, builds:
            t0 = time.perf_counter()
            res = est.path(design, y, path_len=PATH_LEN, eval_fn=evals)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if mode == "blocked":
            print(f"[path] {mode}: compile_sanitizer(0) around the path: no kernel built or "
                  f"loaded")
        counts = ops.launch_counts()
        syncs = engine.host_syncs
        peak = torch.cuda.max_memory_allocated() / 1e9
        solves = log.rows
        iters = sum(s["iters"] for s in solves)
        ends = [t0] + [b for _, b in evals.marks]
        pt_ms = [(a - ends[i]) * 1e3 for i, (a, _) in enumerate(evals.marks)]
        print(f"[path] {mode}: lambda_max {res.lambdas[0] * 2:.6f} (lambda_max_design "
              f"{lmax:.6f}), {len(res)} points, {len(solves)} restricted solves, "
              f"{iters} solve iterations")
        for i, pt in enumerate(res):
            at = [s for s in solves if s["lam"] == pt.lam]
            print(f"[path] {mode} point {i}: lam {pt.lam:.6f} active {pt.screen.get('active')} "
                  f"capacity {pt.screen.get('capacity')} k_cap {at[-1]['k'] if at else None} "
                  f"kkt_rounds {pt.screen.get('kkt_rounds')} deferred "
                  f"{pt.screen.get('deferred')} nnz {pt.nnz} f {pt.f:.4f} iters {pt.n_iters} "
                  f"(all solves {sum(s['iters'] for s in at)}) wall {pt_ms[i]:.1f} ms "
                  f"auprc {pt.metrics['auprc']:.4f} accuracy {pt.metrics['accuracy']:.4f} "
                  f"on {card}")
        for s in solves:
            print(f"[path] {mode} solve: lam {s['lam']:.6f} cap {s['cap']} K {s['k']} "
                  f"iters {s['iters']} reads {s['reads']} {s['ms']:.1f} ms "
                  f"({s['cap'] // (SPARSE_M * opts.tile)} tile steps per iteration)")
        to16 = sum(pt_ms[:PATH_DIRECT + 1])
        d_lam, d_f, d_beta = direct[mode]
        print(f"[path] {mode}: path wall {wall * 1e3:.1f} ms ({sum(pt_ms):.1f} ms in the "
              f"points, the eval's {sum(b - a for a, b in evals.marks) * 1e3:.1f} ms not), "
              f"down to lambda_max/16 {to16:.1f} ms; peak device memory {peak:.2f} GB; host "
              f"syncs {syncs}; launches {counts}; on {card}")
        print(f"[path] {mode}: point {PATH_DIRECT} lam {res.lambdas[PATH_DIRECT]:.6f} f "
              f"{res.f[PATH_DIRECT]:.4f} against the direct fit's lam {d_lam:.6f} f {d_f:.4f} "
              f"(rel gap {abs(res.f[PATH_DIRECT] - d_f) / abs(d_f):.3g})")
        check(res.all_ok and all(s["status"] == 0 for s in solves),
              f"path {mode}: a point or solve tripped: {list(res.statuses)}")
        check(res.betas.shape == (PATH_LEN, p) and bool(torch.isfinite(res.betas).all()),
              f"path {mode}: betas are not a finite ({PATH_LEN}, {p}) stack")
        check(all(res.f[i + 1] <= res.f[i] for i in range(len(res) - 1)),
              f"path {mode}: f increases along the grid: {list(res.f)}")
        check(abs(res.lambdas[PATH_DIRECT] - d_lam) <= 1e-6 * d_lam,
              f"path {mode}: grid point {PATH_DIRECT} is not lambda_max / 16")
        check(abs(res.f[PATH_DIRECT] - d_f) <= 1e-4 * abs(d_f),
              f"path {mode}: f at lambda_max/16 {res.f[PATH_DIRECT]} vs the direct fit's {d_f}")
        for name in ("logistic_stats", "slab_gram", "slab_spmv", tile_kernel):
            check(counts[name] >= iters, f"path {mode}: {name} launched {counts[name]} times "
                  f"for {iters} restricted-solve iterations")
            launches[name] = launches.get(name, 0) + counts[name]
        for s in solves:
            check(s["reads"] == s["iters"] + 2, f"path {mode}: a restricted solve read the "
                  f"device {s['reads']} times for {s['iters']} iterations (+ 2 expected)")
        want = driver_reads(res, len(solves)) + sum(s["reads"] for s in solves) + evals.reads
        check(syncs == want, f"path {mode}: {syncs} host reads, expected {want} (driver "
              f"{driver_reads(res, len(solves))}, solves, eval {evals.reads})")
        check(len(log.masks) == len(res) and log.masks[0].shape[0] == p,
              f"path {mode}: expected one working set of {p} features per point")
        for i, pt in enumerate(res):
            (out_bad, out_ratio), (in_bad, in_ratio) = kkt_recheck(
                torch, rows, vals, y, res.betas[i], pt.lam, log.masks[i])
            print(f"[path] {mode} point {i}: independent KKT pass, beta_j = 0 outside the "
                  f"working set: {out_bad} over lam (1 + {KKT_TOL}) + 1e-7, max |g_j| / lam "
                  f"{out_ratio:.6f}; inside it (left at 0 by the restricted solve): {in_bad} "
                  f"over, max |g_j| / lam {in_ratio:.6f}")
            check(out_bad == 0, f"path {mode} point {i}: {out_bad} features the screen "
                  f"discarded fail the KKT condition")
        # the same stopping rule in the direct fit, where every feature is
        # in the problem: coordinates it leaves at 0 above lam (1 + KKT_TOL)
        (_, _), (d_bad, d_ratio) = kkt_recheck(torch, rows, vals, y, d_beta, d_lam,
                                               torch.ones(p, dtype=torch.bool, device="cuda"))
        print(f"[path] {mode}: the direct fit at lambda_max/16 (no screen): {d_bad} features "
              f"with beta_j = 0 over lam (1 + {KKT_TOL}) + 1e-7, max |g_j| / lam {d_ratio:.6f}")
        print(f"[path] {mode}: bits (sha256) of betas {digest(torch, res.betas)}, f "
              f"{digest(torch, res.f)}")
        walls[mode] = dict(wall_ms=wall * 1e3, to16_ms=to16, peak=peak, syncs=syncs,
                           solves=len(solves), iters=iters, screen_ms=screen_ms, result=res,
                           solves_ms=sum(s["ms"] for s in solves),
                           eval_ms=sum(b - a for a, b in evals.marks) * 1e3)
    return launches, walls


def phase_path_agreement(torch, n: int = 8192, p: int = 4096, n_dense: int = 10_240):
    """Paths on the card against the same paths on the CPU (the plain
    versions), as a user runs them: an 8192 x 4096 slab path on a (1, 16)
    mesh, flat and bucketed (``to_slab_buckets``), ``path_len`` 4 (the
    CPU's match join makes each deeper point dearer), and a local dense
    path on 8192 x 2000, ``path_len`` 6. Per point: lambda within rtol 1e-6
    and a relative f gap < 1e-4; nnz, active, capacity, KKT rounds and the
    largest beta gap side by side; betas within rtol 1e-2 / atol 1e-3 at
    the points whose support (nnz) is at most n / 8, at least eight
    examples per coefficient. Deeper on these slabs the support reaches a
    third of n and more, and a float32 objective fixes beta only to about
    1e-1 there: two plain solvers on the CPU (the flat path slab-native
    and ``densify=True``: the same math in another sum order) differ by
    that much at the same objective, which this phase prints beside the
    card's comparison."""
    from repro_torch.api import BucketedSlabDesign, DenseDesign, LogisticL1, SlabDesign
    from repro_torch.configs.glm import GLM_EPSILON
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.data.byfeature import ByFeature, to_slab_buckets
    from repro_torch.data.synthetic import make_glm_dataset
    from repro_torch.launch.mesh import make_dev_mesh

    density = 0.0015
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, vals, y = slab_data(torch, gen, n, p, density,
                              slab_truth(torch, gen, p, density, "cuda"), "cuda")
    buckets = to_slab_buckets(ByFeature(rows[:, 0].cpu(), vals[:, 0].cpu(), n), 1)
    ds = make_glm_dataset(replace(GLM_EPSILON, num_examples=n_dense),
                          torch.Generator(device="cuda").manual_seed(1), device="cuda")
    opts = DGLMNETOptions(tile=128, block=16, max_iters=100)
    cpu_mesh = make_dev_mesh(1, SPARSE_M, device="cpu")
    cases = [
        ("slab (1, 16) flat", SlabDesign(rows, vals, n), y, opts, True, 4),
        (f"slab (1, 16) bucketed (K classes {buckets.k_classes})",
         BucketedSlabDesign(buckets, n), y, opts, True, 4),
        (f"dense local {ds.X_train.shape[0]}x{ds.X_train.shape[1]}", DenseDesign(ds.X_train),
         ds.y_train, replace(opts, num_blocks=16), False, 6),
    ]

    def hold(label, a_path, b_path, names, n_rows, betas=True):
        held = 0
        for i, (a, b) in enumerate(zip(a_path, b_path)):
            gap = abs(a.f - b.f) / abs(b.f)
            db = max_err(a.beta.cpu(), b.beta.cpu())
            keys = ("active", "capacity", "kkt_rounds")
            held_here = betas and b.nnz <= n_rows // 8
            print(f"[path-agree] {label} point {i}: lam {a.lam:.6f} / {b.lam:.6f}, f "
                  f"{a.f:.6f} / {b.f:.6f} (rel gap {gap:.3g}), nnz {a.nnz} / {b.nnz}, "
                  + ", ".join(f"{k} {a.screen[k]} / {b.screen[k]}" for k in keys)
                  + f", max|dbeta| {db:.3g} ({names}; betas "
                  + ("held" if held_here else "printed") + ")")
            check(abs(a.lam - b.lam) <= 1e-6 * b.lam, f"{label} point {i}: lambdas differ")
            check(gap < 1e-4, f"{label} point {i}: {names} objective gap {gap}")
            if held_here:
                held += 1
                check(torch.allclose(a.beta.cpu(), b.beta.cpu(), rtol=1e-2, atol=1e-3),
                      f"{label} point {i}: {names} betas disagree beyond rtol 1e-2 / atol 1e-3")
        check(held or not betas, f"{label}: no point's support is within n / 8")

    for label, design, yv, o, on_mesh, path_len in cases:
        t0 = time.perf_counter()
        gpu = LogisticL1(o, mesh=make_dev_mesh(1, SPARSE_M) if on_mesh else None,
                         device="cuda").path(design, yv, path_len=path_len)
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_est = LogisticL1(o, mesh=cpu_mesh if on_mesh else None, device="cpu")
        cpu = cpu_est.path(design.to("cpu"), yv.cpu(), path_len=path_len)
        # allow[torch-bench-timing]: the card path's last point ends in a counted host read after its last launch; the CPU path is host work
        t_cpu = time.perf_counter() - t0
        print(f"[path-agree] {label}: card {t_gpu:.1f} s, cpu {t_cpu:.1f} s")
        check(gpu.all_ok and cpu.all_ok, f"{label}: a point tripped: {list(gpu.statuses)}, "
              f"{list(cpu.statuses)}")
        hold(label, gpu, cpu, "card / cpu", design.shape[0])
        if label.endswith("flat"):
            dense = cpu_est.path(design.to("cpu"), yv.cpu(), path_len=path_len, densify=True)
            check(dense.all_ok, f"{label}: a densify-once cpu point tripped")
            hold(f"{label}, cpu only", cpu, dense, "cpu slab-native / cpu densify-once",
                 design.shape[0], betas=False)


# ---------------------------------------------------------------------------
# the process mesh: d-GLMNET across torch.distributed ranks on one card
# ---------------------------------------------------------------------------

#: the (2, 16) mesh: 2 example shards x 2 model ranks, 8 feature blocks each
PM_DATA, PM_WORLD = 2, 4
PM_ITERS = 4
PM_PATH_LEN = 2
#: seconds a spawn of ranks may take before the run fails
PM_DEADLINE = 420
PM_KERNELS = ("logistic_stats", "slab_gram", "slab_spmv", "gram_cd")


def split_examples(torch, rows, vals, n: int, dp: int):
    """(p, 1, K) slabs of row-sorted, front-packed slots (sentinel n) ->
    (p, dp, K') slabs of dp contiguous example shards, local rows
    (sentinel n / dp), front-packed: the layout a process mesh of data
    extent dp takes."""
    n_loc = n // dp
    r, v = rows[:, 0], vals[:, 0]
    shard = torch.where(r < n, torch.div(r, n_loc, rounding_mode="floor"), dp)
    counts = [(shard == s).sum(1) for s in range(dp)]
    k2 = int(max(int(c.max()) for c in counts))
    ar = torch.arange(k2, device=r.device)
    off = torch.zeros_like(counts[0])
    parts_r, parts_v = [], []
    for s in range(dp):
        idx = (off[:, None] + ar).clamp_max(r.shape[1] - 1)
        live = ar[None, :] < counts[s][:, None]
        parts_r.append(torch.where(live, r.gather(1, idx) - s * n_loc, n_loc).to(torch.int32))
        parts_v.append(torch.where(live, v.gather(1, idx), 0.0))
        off = off + counts[s]
    return torch.stack(parts_r, 1), torch.stack(parts_v, 1)


def _rank_run(torch, mesh, call):
    """``call()`` (a fit, or a path and its resume) on a rank with its
    counters zeroed just before and read just after: (result, wall s, host
    reads, launches, collectives, peak GB)."""
    from repro_torch.core import engine
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    mesh.reset_stats()
    engine.host_syncs = 0
    t0 = time.perf_counter()
    res = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, wall, engine.host_syncs, dict(ops.launch_counts()), mesh.stats(),
            torch.cuda.max_memory_allocated() / 1e9)


def mesh_rank_main(work: Path, rank: int) -> int:
    """A rank spawned by :func:`phase_process_mesh` (``--mesh-rank``): reads
    ``spec.json`` in ``work``, writes ``rank<r>.json`` (and the betas it
    is asked for) there. The rank's world ends before it exits (a barrier
    and ``destroy_process_group``; no barrier when the rank raises)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import world_scope

    with world_scope():
        return _mesh_rank(work, rank)


def _mesh_rank(work: Path, rank: int) -> int:
    """:func:`mesh_rank_main`'s work, inside its world's scope."""
    import torch
    import torch.distributed as dist

    from repro_torch.api import DenseDesign, LogisticL1, ShardedDesign, SlabDesign, as_design
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.data.byfeature import SlabBuckets
    from repro_torch.launch.mesh import init_process_mesh, make_process_mesh
    from repro_torch.resilience import EngineFault, FaultPlan, InjectedKill, inject_faults

    spec = json.loads((work / "spec.json").read_text())
    dev, world = spec["device"], spec["world"]
    store = f"file://{work}/store"
    out = {"rank": rank}
    if spec["task"] == "gloo":
        # gloo on CUDA tensors between two processes: a sum and a broadcast
        dist.init_process_group("gloo", init_method=store, world_size=world, rank=rank,
                                timeout=timedelta(seconds=120))
        t = torch.full((1 << 16,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        b = torch.full((1 << 16,), float(rank + 1), device=dev)
        dist.broadcast(b, src=world - 1)
        out.update(sum_ok=bool((t == world * (world + 1) / 2).all()),
                   bcast_ok=bool((b == world).all()), device=str(t.device))
        (work / f"rank{rank}.json").write_text(json.dumps(out))
        return 0
    mesh = init_process_mesh(PM_DATA, SPARSE_M, backend="gloo", init_method=store,
                             world_size=world, rank=rank, device=dev,
                             timeout=timedelta(seconds=180))
    out["coords"] = (mesh.data_rank, mesh.model_rank, mesh.local_blocks)
    (rows, vals, y), _ = sparse_cell(torch, dev=dev, p=spec["p"])
    n = y.shape[0]
    rows2, vals2 = split_examples(torch, rows, vals, n, PM_DATA)
    del rows, vals
    tile = SPARSE_OPTS["tile"]
    # the rank keeps its piece: its shard of its half of the features
    design = ShardedDesign(SlabDesign(rows2, vals2, n), mesh, tile=tile)
    # the same cell as 16 feature-range buckets, for the streamed fit: the
    # rank's 8 pieces leave the card for pinned host memory when its
    # residency is built under the budget below
    streamed = as_design(SlabBuckets(tuple(feature_range_buckets(
        torch, rows2, vals2, STREAM_BUCKETS, False)), n_loc=n // PM_DATA, p=rows2.shape[0]),
        mesh=mesh, tile=tile)
    out["k2"] = int(rows2.shape[2])
    del rows2, vals2
    torch.cuda.empty_cache()
    out["piece"] = dict(lo=design.inner.lo, p_work=design.inner.p_work,
                        nbytes=design.slab_nbytes())
    opts = DGLMNETOptions(cycle_mode="sequential", **{**SPARSE_OPTS, "max_iters": PM_ITERS})
    est = LogisticL1(opts, mesh=mesh, device=dev)
    # the pod axis: the same 4 ranks as a (2, 1, 16) mesh, the same pieces
    pod = make_process_mesh(1, SPARSE_M, pod=PM_DATA, backend="gloo", device=dev,
                            timeout=timedelta(seconds=180))
    out["pod"] = dict(shape=pod.shape, coords=[pod.pod_rank, pod.data_rank, pod.model_rank])
    pod_design = ShardedDesign(design.inner, pod, tile=tile, n=n, p=design.p)
    out["sparse"] = []
    for run, (m_run, est_run, des_run) in enumerate(
            ((mesh, est, design), (pod, LogisticL1(opts, mesh=pod, device=dev), pod_design))):
        res, wall, reads, counts, stats, peak = _rank_run(
            torch, m_run, lambda: est_run.fit(des_run, y, spec["sparse_lam"]))
        np.save(work / f"sparse{run}_r{rank}.npy", res.beta.cpu().numpy())
        out["sparse"].append(dict(wall=wall, iters=res.n_iters, status=res.status,
                                  hist=res.objective_history, reads=reads, counts=counts,
                                  stats=stats, peak=peak))
    del pod_design
    # streamed: the fit under a quarter of the rank's piece bytes
    budget = design.slab_nbytes() // 4
    streamed.device_budget_bytes = budget
    res, wall, reads, counts, stats, peak = _rank_run(
        torch, mesh, lambda: est.fit(streamed, y, spec["sparse_lam"]))
    np.save(work / f"streamed_r{rank}.npy", res.beta.cpu().numpy())
    out["streamed"] = dict(wall=wall, iters=res.n_iters, status=res.status,
                           hist=res.objective_history, reads=reads, counts=counts, peak=peak,
                           budget=budget, residency=streamed.residency_stats()[tile])
    del streamed
    torch.cuda.empty_cache()
    # a nan-inject on a fit cut at 3 iterations, then the healthy fit
    est3 = LogisticL1(replace(opts, max_iters=3), mesh=mesh, device=dev)
    with inject_faults(FaultPlan(engine=EngineFault("margins", at_iter=2), engine_fires=1)):
        bad, wall, reads, counts, _, _ = _rank_run(
            torch, mesh, lambda: est3.fit(design, y, spec["sparse_lam"]))
    healthy = est3.fit(design, y, spec["sparse_lam"])
    nb = len(bad.objective_history)
    out["nan"] = dict(status=bad.status_name, iters=bad.n_iters, reads=reads, counts=counts,
                      finite=bool(torch.isfinite(bad.beta).all()),
                      prefix=bad.objective_history == healthy.objective_history[:nb],
                      healthy_hist=healthy.objective_history, wall=wall)
    # the path, checkpointed on every rank, killed before its last point, resumed
    path_opts = DGLMNETOptions(cycle_mode="sequential", **SPARSE_OPTS)
    path_est = LogisticL1(path_opts, mesh=mesh, device=dev)
    pdir = str(work / "progress")
    killed = []

    def killed_and_resumed():
        try:
            with inject_faults(FaultPlan(kill_after_points=PM_PATH_LEN - 1)):
                path_est.path(design, y, path_len=PM_PATH_LEN, checkpoint_every=1,
                              resume_from=pdir)
        except InjectedKill as e:
            killed.append(str(e))
        return path_est.path(design, y, path_len=PM_PATH_LEN, checkpoint_every=1,
                             resume_from=pdir)

    with PathLog() as log:
        res, wall, reads, counts, stats, peak = _rank_run(torch, mesh, killed_and_resumed)
    np.save(work / f"path_r{rank}.npy", res.betas.cpu().numpy())
    if rank == 0:
        np.save(work / "path_masks.npy", torch.stack(log.masks).cpu().numpy())
        res.save(str(work / "path9a"))
    out["path"] = dict(wall=wall, f=[float(v) for v in res.f],
                       lams=[float(v) for v in res.lambdas],
                       statuses=[int(v) for v in res.statuses],
                       active=[int(pt.screen["active"]) for pt in res],
                       solves=len(log.rows), iters=sum(s["iters"] for s in log.rows),
                       reads=reads, counts=counts, stats=stats, peak=peak, killed=killed,
                       digest=digest(torch, res.betas), slots=sorted(os.listdir(
                           os.path.join(pdir, f"rank-{rank:05d}"))))
    out["piece"]["resident"] = design.residency_stats()[tile]["total_bytes"]
    # serving that path from a store on the process mesh: one batch of 256
    out["serve"] = mesh_serve(torch, mesh, res, work, rank)
    # scoring: every rank gets all n rows of phase 7's beta
    from repro_torch.kernels import ops

    beta7 = torch.from_numpy(np.load(work / "beta7.npy")).to(dev)
    ops.reset_launch_counts()
    mesh.reset_stats()
    scores = est.decision_function(design, beta=beta7)
    np.save(work / f"score_r{rank}.npy", scores.cpu().numpy())
    out["score"] = dict(rows=int(scores.shape[0]), counts=dict(ops.launch_counts()),
                        stats=mesh.stats())
    del design, est, y, res
    torch.cuda.empty_cache()
    from repro_torch.configs.glm import GLM_EPSILON
    from repro_torch.data.synthetic import make_glm_dataset

    gen = torch.Generator(device=dev).manual_seed(0)
    ds = make_glm_dataset(replace(GLM_EPSILON, num_examples=spec["eps_n"]), gen, device=dev)
    design = ShardedDesign(DenseDesign(ds.X_train), mesh, tile=128)
    y = ds.y_train
    del ds
    torch.cuda.empty_cache()
    out["dense_shape"] = [int(d) for d in design.inner.X.shape]
    out["eps_rows"] = int(y.shape[0])
    opts = DGLMNETOptions(num_blocks=SPARSE_M, tile=128, max_iters=100,
                          cycle_mode="sequential", block=16)
    eps_est = LogisticL1(opts, mesh=mesh, device=dev)
    res, wall, reads, counts, stats, peak = _rank_run(
        torch, mesh, lambda: eps_est.fit(design, y, spec["eps_lam"]))
    np.save(work / f"dense_r{rank}.npy", res.beta.cpu().numpy())
    out["dense"] = dict(wall=wall, iters=res.n_iters, status=res.status,
                        hist=res.objective_history, reads=reads, counts=counts, stats=stats,
                        peak=peak)
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def mesh_serve(torch, mesh, path, work: Path, rank: int) -> dict:
    """A rank's ``PathStore`` on the process mesh, its (L, p_pad / R) block
    of ``path``, serving one batch of phase 8b's traffic shape
    (``SERVE_BATCH`` requests of 1 ... ``SERVE_TOKENS`` tokens, the
    path's lambdas): the scores (saved), and at every lambda the served
    scores against ``decision_function`` through the same mesh
    (``serve_glm.smoke_check``, which raises on a mismatch)."""
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_glm import make_traffic, smoke_check
    from repro_torch.serve import PathScorer, PathStore, RequestBatcher

    p = path.betas.shape[1]
    store = PathStore(path, mesh=mesh, tile=SPARSE_OPTS["tile"])
    scorer = PathScorer(store)
    reqs, lams = make_traffic(np.random.default_rng(23), p, SERVE_BATCH, path.lambdas,
                              tokens_per=SERVE_TOKENS)
    batcher = RequestBatcher(p, max_batch=SERVE_BATCH, dp=store.dp, pad_p_to=store.pad_p_to)
    for r, lam in zip(reqs, lams):
        batcher.submit(r, lam)
    batch, blams = batcher.drain()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    mesh.reset_stats()
    engine.host_syncs = 0
    t0 = time.perf_counter()
    scores, version = scorer.score(batch, blams)
    # allow[torch-bench-timing]: score() ends in a counted host read of the scores
    ms = (time.perf_counter() - t0) * 1e3
    counts, stats, reads = dict(ops.launch_counts()), mesh.stats(), engine.host_syncs
    np.save(work / f"serve_r{rank}.npy", scores)
    smoke_check(store, scorer, batch, batch.n_live, path)
    return dict(rows=int(scores.shape[0]), version=version, ms=ms, counts=counts, stats=stats,
                reads=reads, block=list(store.snapshot.betas.shape), p_pad=store.snapshot.p_pad,
                equal_to_decision_function=True)


def spawn_ranks(work: Path, world: int, spec: dict, tag: str):
    """Start ``world`` ranks of this script on ``spec`` and wait for them
    under :data:`PM_DEADLINE`; past it, or on a rank's failure, kill them
    all and fail. Returns each rank's JSON."""
    (work / "spec.json").write_text(json.dumps({**spec, "world": world}))
    procs = []
    for r in range(world):
        log = open(work / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                        "--mesh-rank", str(r), "--mesh-work", str(work)],
                                       stdout=log, stderr=subprocess.STDOUT), log))
    end = time.monotonic() + PM_DEADLINE
    late = False
    for proc, log in procs:
        try:
            # allow[torch-bench-timing]: a deadline on child processes, not a timing of CUDA work
            proc.wait(timeout=max(end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            late = True
            break
    for proc, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    bad = [r for r, (proc, _) in enumerate(procs) if proc.returncode != 0]
    if late or bad:
        for r in range(world):
            print(f"[mesh] {tag} rank {r} log tail:\n{(work / f'rank{r}.log').read_text()[-4000:]}")
        fail(f"process mesh {tag}: " + (f"ranks past the {PM_DEADLINE} s deadline"
                                        if late else f"ranks {bad} failed"))
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]


def mesh_new_checks(torch, got, mw: Path, card: str, launches: dict, path_head):
    """Phase 9a's checks of streamed residency, fault injection,
    checkpoint-resume, serving and the pod axis on the four ranks' runs
    (see the module docstring); adds their launches to ``launches``."""
    from repro_torch.api import PathResult
    from repro_torch.serve import PathScorer, PathStore, RequestBatcher
    from repro_torch.launch.serve_glm import make_traffic

    r0 = got[0]
    b0 = np.load(mw / "sparse0_r0.npy")
    # pod: the second fit ran on (2, 1, 16) over the same ranks
    for g in got:
        s0, s1 = g["sparse"]
        same = (np.array_equal(np.load(mw / f"sparse1_r{g['rank']}.npy"),
                               np.load(mw / f"sparse0_r{g['rank']}.npy"))
                and s1["hist"] == s0["hist"])
        print(f"[mesh] rank {g['rank']} pod mesh {g['pod']['shape']} (pod, data, model) "
              f"{g['pod']['coords']}: fit bit-equal to the (2, {SPARSE_M}) fit {same}; "
              f"collectives per iteration {_per_iter(s1['stats'], s1['iters'])}")
        check(same, f"mesh pod: rank {g['rank']}'s (2, 1, {SPARSE_M}) fit differs from its "
              f"(2, {SPARSE_M}) fit")
    # streamed: the same fit under a quarter of each rank's piece bytes
    for g in got:
        st, s0 = g["streamed"], g["sparse"][0]
        res_ = st["residency"]
        same = (np.array_equal(np.load(mw / f"streamed_r{g['rank']}.npy"), b0)
                and st["hist"] == s0["hist"])
        print(f"[mesh] rank {g['rank']} streamed fit under {st['budget']} B (a quarter of its "
              f"piece's {res_['total_bytes']} B, {res_['n_buckets']} pieces): "
              f"{res_['bytes_h2d'] / 1e6:.1f} MB host->device in {res_['puts']} transfers, "
              f"{res_['evictions']} evictions, {st['wall'] * 1e3 / max(st['iters'], 1):.1f} ms "
              f"per iteration (resident {s0['wall'] * 1e3 / max(s0['iters'], 1):.1f}), peak "
              f"{st['peak']:.2f} GB (resident {s0['peak']:.2f}); bit-equal to the resident fit "
              f"{same}; host reads {st['reads']} / {s0['reads']}; on {card}")
        check(same, f"mesh streamed: rank {g['rank']}'s streamed fit differs from the resident")
        check(res_["streamed"] and res_["evictions"] > 0
              and res_["resident_bytes"] <= res_["budget_bytes"],
              f"mesh streamed: rank {g['rank']} did not stream within its budget: {res_}")
        check(st["reads"] == s0["reads"], f"mesh streamed: rank {g['rank']} read "
              f"{st['reads']} times, the resident fit {s0['reads']}")
        for name in PM_KERNELS:
            check(st["counts"].get(name, 0) >= st["iters"],
                  f"mesh streamed: rank {g['rank']} launched {name} too few times")
            launches[name] += st["counts"].get(name, 0)
    # fault: a nan-inject at iteration 2 of a fit cut at 3
    nan0 = r0["nan"]
    for g in got:
        nan = g["nan"]
        print(f"[mesh] rank {g['rank']} nan-inject at iteration 2 (fit cut at 3): status "
              f"{nan['status']} after {nan['iters']} iterations, beta finite {nan['finite']}, "
              f"history a prefix of the healthy fit's {nan['prefix']}, host reads {nan['reads']},"
              f" {nan['wall']:.2f} s")
        check((nan["status"], nan["iters"]) == (nan0["status"], nan0["iters"])
              == ("NONFINITE_OBJECTIVE", 1) and nan["finite"] and nan["prefix"],
              f"mesh nan-inject: rank {g['rank']} ended {nan['status']} after {nan['iters']}")
        check(nan["healthy_hist"][:3] == g["sparse"][0]["hist"][:3],
              f"mesh nan-inject: rank {g['rank']}'s healthy fit after the fault is not the "
              f"resident fit's first iterations")
        for name in PM_KERNELS:
            launches[name] += nan["counts"].get(name, 0)
    # checkpoint-resume: killed after the path's last point but one on every rank,
    # resumed for the last
    pth = r0["path"]
    for g in got:
        gp = g["path"]
        print(f"[mesh] rank {g['rank']} checkpointed path: {gp['killed']}; slots "
              f"{gp['slots']}; resumed betas digest {gp['digest']}; host reads {gp['reads']}")
        check(len(gp["killed"]) == 1
              and f"after {PM_PATH_LEN - 1} path points" in gp["killed"][0],
              f"mesh path: rank {g['rank']} was not killed after point {PM_PATH_LEN - 1}: "
              f"{gp['killed']}")
        check(gp["digest"] == pth["digest"], f"mesh path: rank {g['rank']}'s digest differs")
    print(f"[mesh] path betas (the killed and resumed path) bits (sha256) {pth['digest']}")
    # serve: the resumed path from a store on the process mesh, one batch of 256
    s_0 = np.load(mw / "serve_r0.npy")
    path = PathResult.load(str(mw / "path9a"))
    local = PathStore(path)
    reqs, lams = make_traffic(np.random.default_rng(23), path.betas.shape[1], SERVE_BATCH,
                              path.lambdas, tokens_per=SERVE_TOKENS)
    batcher = RequestBatcher(path.betas.shape[1], max_batch=SERVE_BATCH)
    for r, lam in zip(reqs, lams):
        batcher.submit(r, lam)
    batch, blams = batcher.drain()
    want, _ = PathScorer(local).score(batch, blams)
    err = float(np.abs(s_0 - want).max() / max(np.abs(want).max(), 1e-30))
    for g in got:
        sv = g["serve"]
        same = np.array_equal(np.load(mw / f"serve_r{g['rank']}.npy"), s_0)
        print(f"[mesh] rank {g['rank']} serve on (2, {SPARSE_M}): a {sv['block']} block of the "
              f"({PM_PATH_LEN}, {sv['p_pad']}) stack; {sv['rows']} scores in {sv['ms']:.1f} ms (version "
              f"{sv['version']}), launches {sv['counts']}, collectives {sv['stats']}, host reads "
              f"{sv['reads']}; bit-equal to decision_function at every lambda "
              f"{sv['equal_to_decision_function']}; bit-equal to rank 0 {same}; on {card}")
        check(sv["rows"] == SERVE_BATCH and same and sv["equal_to_decision_function"]
              and sv["version"] == r0["serve"]["version"]
              and sv["counts"].get("slab_path_spmv", 0) == 1,
              f"mesh serve: rank {g['rank']} served {sv['rows']} scores, or they differ, or "
              f"it launched slab_path_spmv {sv['counts'].get('slab_path_spmv', 0)} times")
        launches["slab_path_spmv"] = (launches.get("slab_path_spmv", 0)
                                      + sv["counts"].get("slab_path_spmv", 0))
    print(f"[mesh] served scores vs a local store of the same path: max |diff| / max |score| "
          f"{err:.3g}")
    check(err <= 1e-5, f"mesh serve vs the local store: relative error {err}")


def _per_iter(stats: dict, iters: int) -> str:
    return ", ".join(f"{ax} {calls / max(iters, 1):.1f} calls ({nbytes / max(iters, 1) / 1e6:.3f} "
                     f"MB)" for ax, (calls, nbytes) in stats.items())


def phase_process_mesh(torch, card, cell, sparse_fit, sparse_lam: float, eps_n: int,
                       eps_lam: float, eps_f: float, path_head):
    """Phase 9a: d-GLMNET on a process mesh (see the module docstring).
    ``sparse_fit`` is phase 7's sequential fit (iterations, f, beta,
    history), ``eps_lam`` / ``eps_f`` phase 4's sequential lambda and f,
    ``path_head`` phase 8's sequential path f at its first points; the
    ranks draw the epsilon cell of ``eps_n`` examples from phase 4's seed."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.api import LogisticL1, SlabDesign
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh, make_process_mesh

    t_phase = time.perf_counter()
    (rows, vals, y), _ = cell
    n, p = y.shape[0], rows.shape[0]
    launches = {}
    print("[mesh] co-located ranks share one card and stage every gloo collective through "
          "the host: their walls are not a multi-card speed")
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        # 1. gloo reduces CUDA tensors between two spawned ranks
        (work / "gloo").mkdir()
        got = spawn_ranks(work / "gloo", 2, dict(task="gloo", device="cuda"), "gloo")
        print(f"[mesh] gloo between 2 spawned ranks on {got[0]['device']}: all_reduce "
              f"{[g['sum_ok'] for g in got]}, broadcast {[g['bcast_ok'] for g in got]}")
        check(all(g["sum_ok"] and g["bcast_ok"] for g in got),
              "gloo did not reduce or broadcast a CUDA tensor between two ranks")

        # 2. a one-rank NCCL mesh: bit-equal to phase 7's (1, 16) fit
        dist.init_process_group("nccl", init_method=f"file://{work}/nccl", world_size=1,
                                rank=0, timeout=timedelta(seconds=120))
        try:
            mesh = make_process_mesh(1, SPARSE_M, backend="nccl", device="cuda")
            t = torch.ones(4, device="cuda")
            dist.all_reduce(t)
            opts = DGLMNETOptions(cycle_mode="sequential", **SPARSE_OPTS)
            est = LogisticL1(opts, mesh=mesh, device="cuda")
            design = SlabDesign(rows, vals, n)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            engine.host_syncs = 0
            t0 = time.perf_counter()
            res, sites, stacks = under_sync_debug(torch, lambda: est.fit(design, y, sparse_lam))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, reads = ops.launch_counts(), engine.host_syncs
        finally:
            dist.destroy_process_group()
        iters, f7, beta7, hist7 = sparse_fit
        same = torch.equal(res.beta, beta7) and res.objective_history == hist7
        print(f"[mesh] one-rank NCCL mesh (1, {SPARSE_M}), backend {mesh.backend}, on the "
              f"webspam cell: {res.n_iters} iterations, f {res.f:.6f} (phase 7 {f7:.6f}), "
              f"bit-equal to phase 7 {same}, host reads {reads}, synchronising calls "
              f"{dict(sites)}, {wall:.3f} s, launches {counts}, on {card}")
        check(same, "the one-rank NCCL mesh differs from phase 7's DevMesh fit")
        check(reads == res.n_iters + 2, f"one-rank NCCL mesh: {reads} host reads for "
              f"{res.n_iters} iterations (+ 2 expected)")
        check_sync_sites(sites, stacks, "mesh nccl")
        for name in PM_KERNELS:
            check(counts[name] >= res.n_iters, f"one-rank NCCL mesh: {name} launched "
                  f"{counts[name]} times for {res.n_iters} iterations")
            launches[name] = launches.get(name, 0) + counts[name]
        del est, design

        # phase 7's fit cut at PM_ITERS, the co-located mesh's reference
        cut = LogisticL1(replace(opts, max_iters=PM_ITERS), mesh=make_dev_mesh(1, SPARSE_M),
                         device="cuda").fit(SlabDesign(rows, vals, n), y, sparse_lam)

        # 3-5. four co-located gloo ranks: the (2, 16) mesh on the cells
        (work / "mesh").mkdir()
        np.save(work / "mesh" / "beta7.npy", beta7.cpu().numpy())
        scores7 = LogisticL1(opts, mesh=make_dev_mesh(1, SPARSE_M), device="cuda"
                             ).decision_function(SlabDesign(rows, vals, n), beta=beta7)
        t0 = time.perf_counter()
        got = spawn_ranks(work / "mesh", PM_WORLD,
                          dict(task="mesh", device="cuda", p=p, sparse_lam=sparse_lam,
                               eps_lam=eps_lam, eps_n=eps_n), "mesh")
        spawn_s = time.perf_counter() - t0
        mw = work / "mesh"
        r0 = got[0]
        # each rank holds its piece: its shard of its 1 / R of the padded features
        r_model = PM_WORLD // PM_DATA
        p_work = p + (-p) % (SPARSE_M * SPARSE_OPTS["tile"])
        eps_pad = 2000 + (-2000) % (SPARSE_M * 128)
        for g in got:
            d_rank, m_rank, _ = g["coords"]
            pc = g["piece"]
            want = p_work // r_model * r0["k2"] * 8
            print(f"[mesh] rank {g['rank']} (data {d_rank}, model {m_rank}) holds slab features "
                  f"[{pc['lo']}, {pc['lo'] + p_work // r_model}) of {p_work}: {pc['nbytes'] / 1e6:.1f} "
                  f"MB resident ({pc['resident'] / 1e6:.1f} MB in its residency; the parent held "
                  f"every feature, {p_work * r0['k2'] * 8 / 1e6:.1f} MB); epsilon shard "
                  f"{tuple(g['dense_shape'])} (the parent's ({g['eps_rows'] // PM_DATA}, 2000)); "
                  f"peaks: sparse fit {g['sparse'][0]['peak']:.2f} GB, path "
                  f"{g['path']['peak']:.2f} GB, epsilon {g['dense']['peak']:.2f} GB (the parent's "
                  f"2.33 / 2.37, -, 4.26 GB), on {card}")
            check(pc["nbytes"] == pc["resident"] == want and pc["lo"] == m_rank * (p_work // r_model),
                  f"mesh: rank {g['rank']} holds {pc} slab bytes, not its piece's {want}")
            check(g["dense_shape"] == [g["eps_rows"] // PM_DATA, eps_pad // r_model],
                  f"mesh: rank {g['rank']} holds an epsilon shard of {g['dense_shape']}")
        # decision_function: all n rows on every rank, phase 7's scores
        s0 = np.load(mw / "score_r0.npy")
        ref = scores7.cpu().numpy()
        err = float(np.abs(s0 - ref).max() / max(np.abs(ref).max(), 1e-30))
        for g in got:
            check(g["score"]["rows"] == n and np.array_equal(np.load(mw / f"score_r{g['rank']}.npy"),
                                                             s0),
                  f"mesh decision_function: rank {g['rank']} has {g['score']['rows']} rows or "
                  f"differs from rank 0")
            launches["slab_spmv"] += g["score"]["counts"].get("slab_spmv", 0)
        print(f"[mesh] decision_function on (2, {SPARSE_M}): {s0.shape[0]} rows on every rank, "
              f"bit-equal across ranks; max |score - phase 7's| / max |phase 7's| {err:.3g}; "
              f"collectives {r0['score']['stats']}")
        check(err <= 1e-5, f"mesh decision_function vs phase 7's scores: relative error {err}")
        for g in got:
            d_rank, m_rank, blocks = g["coords"]
            for i, s in enumerate(g["sparse"]):
                on = f"(2, {SPARSE_M})" if i == 0 else f"(2, 1, {SPARSE_M}) pod mesh"
                print(f"[mesh] rank {g['rank']} (data {d_rank}, model {m_rank}, {blocks} "
                      f"blocks) sparse run {i + 1} on {on}: {s['iters']} iterations, wall "
                      f"{s['wall']:.3f} s, {s['wall'] * 1e3 / s['iters']:.1f} ms per "
                      f"iteration, collectives per iteration {_per_iter(s['stats'], s['iters'])}, "
                      f"host reads {s['reads']}, peak {s['peak']:.2f} GB, on {card}")
            pth, dn = g["path"], g["dense"]
            print(f"[mesh] rank {g['rank']} path ({PM_PATH_LEN} points): wall {pth['wall']:.3f} "
                  f"s, {pth['solves']} solves of {pth['iters']} iterations, collectives "
                  f"{pth['stats']}, model calls per lambda "
                  f"{pth['stats'].get('model', (0, 0))[0] / PM_PATH_LEN:.1f}, peak "
                  f"{pth['peak']:.2f} GB, on {card}")
            print(f"[mesh] rank {g['rank']} epsilon dense: {dn['iters']} iterations, wall "
                  f"{dn['wall']:.3f} s, {dn['wall'] * 1e3 / dn['iters']:.1f} ms per iteration, "
                  f"collectives per iteration {_per_iter(dn['stats'], dn['iters'])}, peak "
                  f"{dn['peak']:.2f} GB, on {card}")
        # every rank: the same bits, every kernel of the path in every iteration
        for run in range(2):
            b0 = np.load(mw / f"sparse{run}_r0.npy")
            for g in got:
                s = g["sparse"][run]
                check(s["status"] == 0 and s["iters"] == r0["sparse"][run]["iters"],
                      f"mesh sparse run {run + 1}: rank {g['rank']} status {s['status']}")
                check(np.array_equal(np.load(mw / f"sparse{run}_r{g['rank']}.npy"), b0)
                      and s["hist"] == r0["sparse"][run]["hist"],
                      f"mesh sparse run {run + 1}: rank {g['rank']} differs from rank 0")
                check(s["reads"] == s["iters"] + 2, f"mesh sparse: rank {g['rank']} read "
                      f"{s['reads']} times for {s['iters']} iterations (+ 2 expected)")
                for name in PM_KERNELS:
                    check(s["counts"].get(name, 0) >= s["iters"],
                          f"mesh sparse: rank {g['rank']} launched {name} "
                          f"{s['counts'].get(name, 0)} times in {s['iters']} iterations")
        for name in PM_KERNELS:
            launches[name] += sum(g["sparse"][0]["counts"].get(name, 0) for g in got)
        b1 = np.load(mw / "sparse0_r0.npy")
        beta_m = torch.from_numpy(b1)
        f_m = r0["sparse"][0]["hist"][-1]
        gap = abs(f_m - cut.f) / abs(cut.f)
        print(f"[mesh] (2, {SPARSE_M}) on 4 co-located gloo ranks, slabs (p, 2, "
              f"{r0['k2']}): f {f_m:.6f} after {r0['sparse'][0]['iters']} iterations against "
              f"phase 7's fit cut at {cut.n_iters} f {cut.f:.6f}: rel gap {gap:.3g}, max|dbeta| "
              f"{max_err(beta_m, cut.beta.cpu()):.3g}; ranks bit-equal")
        check(gap < 1e-4, f"mesh sparse vs phase 7 cut at {PM_ITERS}: rel gap {gap}")
        check(torch.allclose(beta_m, cut.beta.cpu(), rtol=1e-2, atol=1e-3),
              "mesh sparse betas disagree with phase 7's cut beyond rtol 1e-2 / atol 1e-3")
        mesh_new_checks(torch, got, mw, card, launches, path_head)
        # 4. the epsilon dense cell against phase 4's sequential fit
        d0 = np.load(mw / "dense_r0.npy")
        for g in got:
            check(g["dense"]["status"] == 0 and np.array_equal(
                np.load(mw / f"dense_r{g['rank']}.npy"), d0)
                and g["dense"]["hist"] == r0["dense"]["hist"],
                f"mesh dense: rank {g['rank']} tripped or differs from rank 0")
            for name in ("logistic_stats", "gram_cd"):
                check(g["dense"]["counts"].get(name, 0) >= g["dense"]["iters"],
                      f"mesh dense: rank {g['rank']} launched {name} too few times")
                launches[name] += g["dense"]["counts"].get(name, 0)
        f_d = r0["dense"]["hist"][-1]
        gap = abs(f_d - eps_f) / abs(eps_f)
        print(f"[mesh] epsilon dense on (2, {SPARSE_M}): f {f_d:.6f} ({r0['dense']['iters']} "
              f"iterations) against phase 4's {eps_f:.6f}: rel gap {gap:.3g}")
        check(gap < 1e-4, f"mesh dense vs phase 4: rel gap {gap}")
        # 5. the path: every point OK, certified, and at phase 8's objective
        pth = r0["path"]
        betas = np.load(mw / "path_r0.npy")
        masks = torch.from_numpy(np.load(mw / "path_masks.npy")).cuda()
        for g in got:
            check(np.array_equal(np.load(mw / f"path_r{g['rank']}.npy"), betas)
                  and g["path"]["f"] == pth["f"],
                  f"mesh path: rank {g['rank']} differs from rank 0")
            for name in PM_KERNELS:
                check(g["path"]["counts"].get(name, 0) >= g["path"]["iters"],
                      f"mesh path: rank {g['rank']} launched {name} too few times")
                launches[name] += g["path"]["counts"].get(name, 0)
        check(all(s == 0 for s in pth["statuses"]), f"mesh path: statuses {pth['statuses']}")
        for i in range(PM_PATH_LEN):
            beta = torch.from_numpy(betas[i]).cuda()
            (out_bad, out_ratio), (in_bad, in_ratio) = kkt_recheck(
                torch, rows, vals, y, beta, pth["lams"][i], masks[i])
            rel = abs(pth["f"][i] - path_head[i]) / abs(path_head[i])
            print(f"[mesh] path point {i}: lam {pth['lams'][i]:.6f} active {pth['active'][i]} f "
                  f"{pth['f'][i]:.4f} (phase 8 {path_head[i]:.4f}, rel gap {rel:.3g}); KKT "
                  f"outside the working set {out_bad} over (max |g|/lam {out_ratio:.6f}), inside "
                  f"{in_bad}")
            check(out_bad == 0, f"mesh path point {i}: {out_bad} discarded features fail KKT")
            check(rel <= 1e-4, f"mesh path point {i}: f {pth['f'][i]} vs phase 8 {path_head[i]}")
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s (the 4-rank spawn {spawn_s:.1f} "
          f"s), on {card}")
    return launches


# ---------------------------------------------------------------------------
# the streamed path: slab buckets through a device budget
# ---------------------------------------------------------------------------

#: feature-range buckets of the streamed path phase, and its grid points
STREAM_BUCKETS = 16
STREAM_PATH_LEN = 4


def feature_range_buckets(torch, rows, vals, parts: int, host: bool):
    """The cell's (p, 1, K) slabs split into ``parts`` equal feature
    ranges, each with its feature ids: a ``SlabBuckets`` (the cell's
    uniform density gives ``to_slab_buckets`` about two K classes, whose
    adjacent pair is nearly all of it, so it could not stream). With
    ``host``, each bucket is a pinned host copy."""
    width = rows.shape[0] // parts
    buckets = []
    for i in range(parts):
        r, v = rows[i * width:(i + 1) * width], vals[i * width:(i + 1) * width]
        fid = torch.arange(i * width, (i + 1) * width, device=r.device)
        if host:
            r, v, fid = r.cpu().pin_memory(), v.cpu().pin_memory(), fid.cpu()
        buckets.append((r, v, fid))
    return buckets


def phase_streamed_path(torch, cell, card):
    """``LogisticL1.path`` on the cell split into 16 feature-range buckets
    on a (1, 16) mesh, sequential, ``path_len`` 4, twice from the same
    buckets: resident on the card, and from pinned host buckets under
    ``device_budget_bytes = slab_nbytes(tile) // 4`` (4 of the 16 buckets,
    the floor is 2). The streamed run must equal the resident one bit for
    bit, with evictions and re-streams counted and the budget kept."""
    from repro_torch.api import LogisticL1, SlabDesign, as_design, make_design_eval, resolve
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.data.byfeature import SlabBuckets
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.obs import observe

    (rows, vals, y), (rt, vt, yt) = cell
    n, p = y.shape[0], rows.shape[0]
    mesh = make_dev_mesh(1, SPARSE_M)
    opts = DGLMNETOptions(cycle_mode="sequential", **SPARSE_OPTS)
    tile = opts.tile
    dev_b = SlabBuckets(tuple(feature_range_buckets(torch, rows, vals, STREAM_BUCKETS, False)),
                        n_loc=n, p=p)
    t0 = time.perf_counter()
    host_b = SlabBuckets(tuple(feature_range_buckets(torch, rows, vals, STREAM_BUCKETS, True)),
                         n_loc=n, p=p)
    t_pin = time.perf_counter() - t0
    sizing = as_design(dev_b, mesh=mesh, tile=tile)
    total = sizing.slab_nbytes(tile)
    budget = total // 4
    print(f"[stream] {STREAM_BUCKETS} feature-range buckets of {p // STREAM_BUCKETS} "
          f"features, {total} slab bytes ({sizing.slab_bucket_nbytes(tile)[0]} each); "
          f"budget {budget} bytes; host copies pinned in {t_pin:.2f} s")

    def designs():
        resident = as_design(dev_b, mesh=mesh, tile=tile)
        streamed = as_design(host_b, mesh=mesh, tile=tile, device_budget_bytes=budget)
        return resident, streamed

    est = LogisticL1(opts, mesh=mesh, device="cuda")
    resident, streamed = designs()
    check(resolve(resident, opts).residency == "resident"
          and resolve(streamed, opts).residency == "streamed",
          "the strategy did not resolve resident and streamed residency")
    # the first two points of the streamed path under torch's sync debug mode
    head, sites, stacks = under_sync_debug(torch, lambda: est.path(streamed, y, path_len=2))
    print(f"[stream] streamed: first two points under sync debug mode: f {list(head.f)}; "
          f"synchronising calls by call site: {dict(sites)}")
    check_sync_sites(sites, stacks, "stream")
    runs, launches = {}, {}
    for label in ("resident", "streamed"):
        resident, streamed = designs()
        design = resident if label == "resident" else streamed
        evals = TimedEval(make_design_eval(SlabDesign(rt, vt, yt.shape[0]), yt, mesh=mesh,
                                           tile=tile))
        # the eval's test design gets its residency here, outside the traced
        # window, so that the one residency the window registers is the path's
        evals.fn(torch.zeros(p, device="cuda"))
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        engine.host_syncs = 0
        with PathLog() as log, observe() as obs:
            t0 = time.perf_counter()
            res = est.path(design, y, path_len=STREAM_PATH_LEN, eval_fn=evals)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        syncs = engine.host_syncs
        peak = torch.cuda.max_memory_allocated()
        (stats,) = design.residency_stats().values()
        mirrored = obs.registry.collect()["callbacks"]
        (split,) = path_splits(obs.tracer.spans)
        print(f"[stream] {label} under observe(): {split_line(split)}; on {card}")
        check(list(mirrored.values()) == [stats]
              and all(k.startswith("residency.tile") for k in mirrored),
              f"stream {label}: the residency callback {mirrored} does not mirror {stats}")
        check(split["counts"]["bucket_stream"] == stats["misses"],
              f"stream {label}: {split['counts']['bucket_stream']} bucket_stream spans for "
              f"{stats['misses']} misses")
        iters = sum(s["iters"] for s in log.rows)
        ends = [t0] + [b for _, b in evals.marks]
        pt_ms = [(a - ends[i]) * 1e3 for i, (a, _) in enumerate(evals.marks)]
        # one screen pass alone, and the bytes it moves
        m0 = torch.zeros(n, device="cuda")
        before = dict(stats)
        design._screen_abs_work(y, m0, tile=tile)
        torch.cuda.synchronize()
        (after,) = design.residency_stats().values()
        pass_bytes = after["bytes_h2d"] - before["bytes_h2d"]
        screen_ms = time_ms(torch, lambda: design._screen_abs_work(y, m0, tile=tile),
                            torch.empty(1, device="cuda"), reps=5, warmup=1)
        print(f"[stream] {label}: {len(res)} points, {len(log.rows)} restricted solves, "
              f"{iters} solve iterations; path wall {wall * 1e3:.1f} ms, per point "
              f"{[round(t, 1) for t in pt_ms]} ms; host syncs {syncs}; launches {counts}; on "
              f"{card}")
        print(f"[stream] {label}: residency {stats}")
        print(f"[stream] {label}: one screen pass {screen_ms:.3f} ms (CUDA events, median of "
              f"5), {pass_bytes} bytes host->device per pass"
              + (f" ({pass_bytes / (screen_ms * 1e-3) / 1e9:.2f} GB/s over the pass)"
                 if pass_bytes else "")
              + f"; peak device memory {peak / 1e9:.3f} GB "
              f"({(peak - held) / 1e9:.3f} GB above the {held / 1e9:.3f} GB held before), "
              f"manager resident bytes {stats['resident_bytes']}; on {card}")
        check(res.all_ok and all(s["status"] == 0 for s in log.rows),
              f"stream {label}: a point or solve tripped: {list(res.statuses)}")
        for name in ("logistic_stats", "slab_gram", "slab_spmv", "gram_cd"):
            check(counts[name] >= iters, f"stream {label}: {name} launched {counts[name]} "
                  f"times for {iters} restricted-solve iterations")
            launches[name] = launches.get(name, 0) + counts[name]
        runs[label] = dict(res=res, syncs=syncs, stats=stats, wall_ms=wall * 1e3,
                           screen_ms=screen_ms, peak=peak, pass_bytes=pass_bytes, budget=budget,
                           host_buckets=host_b, split=split)
        del design, resident, streamed
    a, b = runs["resident"]["res"], runs["streamed"]["res"]
    same = (torch.equal(a.betas, b.betas) and np.array_equal(a.f, b.f)
            and np.array_equal(a.nnz, b.nnz) and a.screen == b.screen
            and np.array_equal(a.lambdas, b.lambdas))
    st = runs["streamed"]["stats"]
    print(f"[stream] streamed vs resident, both traced: betas, f, nnz, lambdas and every "
          f"screen count {'bit-equal' if same else 'DIFFERENT'}; host reads "
          f"{runs['streamed']['syncs']} / {runs['resident']['syncs']} -> "
          f"{'ok' if same else 'MISMATCH'}")
    sa, sb = runs["resident"]["split"], runs["streamed"]["split"]
    delta = {name: sb["phases"][name] - sa["phases"][name] for name in PATH_PHASES}
    print(f"[stream] streamed - resident by phase (ms): wall {sb['wall_ms'] - sa['wall_ms']:+.1f}"
          f", " + ", ".join(f"{name} {d:+.1f}" for name, d in delta.items())
          + f", lambda_point outside its spans {sb['point_other_ms'] - sa['point_other_ms']:+.1f}"
          f", path outside its children {sb['setup_ms'] - sa['setup_ms']:+.1f}; on {card}")
    check(same, "the streamed path differs from the resident one")
    check(st["streamed"] and st["evictions"] > 0 and st["misses"] > st["n_buckets"]
          and st["bytes_h2d"] > st["total_bytes"] and st["resident_bytes"] <= st["budget_bytes"],
          f"the streamed residency did not stream within its budget: {st}")
    check(runs["streamed"]["syncs"] == runs["resident"]["syncs"],
          "the streamed path read the device more often than the resident one")
    return launches, runs


# ---------------------------------------------------------------------------
# serving the certified path: checkpoint, store, batcher, scorer
# ---------------------------------------------------------------------------

SERVE_ROUNDS = 20


def serve_stage_times(torch, scorer, batcher, reqs, lams, card):
    """One batch's time by stage: host encode and pack (submit, drain),
    the host-to-device copy (``put_slab`` from pinned staging),
    ``slab_order`` and the kernel (CUDA events each), then the scorer's
    whole call."""
    slab_spmv = import_module("repro_torch.kernels.slab_spmv")
    from repro_torch.kernels.slab_spmv import slab_order
    from repro_torch.serve.scoring import stage_batch

    t0 = time.perf_counter()
    for r, lam in zip(reqs, lams):
        batcher.submit(r, lam)
    batch, blams = batcher.drain()
    t_pack = (time.perf_counter() - t0) * 1e3
    snap = scorer.store.snapshot
    lam_idx = np.zeros(batch.batch_cap, np.int32)
    lam_idx[:batch.n_live] = snap.indices_of(blams)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev[0].record()
    rows, vals, idx = stage_batch(batch, lam_idx, snap.betas.device)
    ev[1].record()
    M = 1 if scorer.store.mesh is None else scorer.store.mesh.shape["model"]
    rows = rows[:, 0].reshape(M, batch.p_pad // M, -1)
    vals = vals[:, 0].reshape(M, batch.p_pad // M, -1)
    order = slab_order(rows, vals)
    ev[2].record()
    out = torch.zeros(M, batch.n_loc, device="cuda")
    slab_spmv.slab_path_spmv_kernel(order, vals, idx,
                                    snap.betas.reshape(snap.num_points, M, -1), out,
                                    n_loc=batch.n_loc)
    ev[3].record()
    torch.cuda.synchronize()
    t_dev = (time.perf_counter() - t1) * 1e3
    slab_spmv.path_launches -= 1            # a measurement, not the serve path
    t0 = time.perf_counter()
    scorer.score(batch, blams)
    t_score = (time.perf_counter() - t0) * 1e3
    live = int((batch.row_idx < batch.n_loc).sum())
    return dict(pack_ms=t_pack, copy_ms=ev[0].elapsed_time(ev[1]),
                order_ms=ev[1].elapsed_time(ev[2]), kernel_ms=ev[2].elapsed_time(ev[3]),
                device_wall_ms=t_dev, score_ms=t_score, live=live,
                slab_bytes=batch.row_idx.nbytes + batch.values.nbytes)


def serve_report(obs, label: str, med: dict, card: str):
    """The serve spans of one traced store: ``encode``, ``drain`` and
    ``score`` per timed batch (the children of the ``serve`` span of
    ``serve_loop``) beside the stage times, the ``swap`` spans, the
    submit -> score latency percentiles and the last queue depth. Fails
    unless every timed request was encoded and marked scored and every
    round drained and scored once."""
    spans = obs.tracer.spans
    (root,) = [r for r in spans if r["name"] == "serve" and r["parent"] is None]
    under = [r for r in spans if r["parent"] == root["sid"]]
    per = {name: (sum(r["dur"] for r in under if r["name"] == name) * 1e3 / SERVE_ROUNDS,
                  sum(1 for r in under if r["name"] == name))
           for name in ("encode", "drain", "score")}
    swaps = [r["dur"] * 1e3 for r in spans if r["name"] == "swap"]
    summary = obs.summary()
    lat = summary["histograms"]["serve.latency_s"]
    depth = summary["gauges"].get("serve.queue_depth")
    print(f"[serve] {label} under observe(): per batch of {SERVE_BATCH} (mean of "
          f"{SERVE_ROUNDS}, ms): " + ", ".join(f"{name} {ms:.3f} ({n} spans)"
                                             for name, (ms, n) in per.items())
          + f"; the serve span {root['dur'] * 1e3 / SERVE_ROUNDS:.2f} per batch; beside the "
          f"stage times: host encode + pack {med['pack_ms']:.2f}, the scorer's whole call "
          f"{med['score_ms']:.2f}; swap spans {[round(ms, 3) for ms in swaps]} ms; "
          f"serve.latency_s ({lat['count']} requests) p50 {lat['p50'] * 1e3:.2f} p95 "
          f"{lat['p95'] * 1e3:.2f} p99 {lat['p99'] * 1e3:.2f} ms; last serve.queue_depth "
          f"{depth}; on {card}")
    check(per["encode"][1] == SERVE_ROUNDS * SERVE_BATCH and per["drain"][1] == SERVE_ROUNDS
          and per["score"][1] == SERVE_ROUNDS,
          f"serve {label}: span counts {per} for {SERVE_ROUNDS} rounds of {SERVE_BATCH}")
    check(lat["count"] == SERVE_ROUNDS * SERVE_BATCH,
          f"serve {label}: serve.latency_s counted {lat['count']} requests")


def phase_serve(torch, card, path):
    """Serve phase 8's sequential path (8 points, p = 2^20) from a
    checkpoint round trip, on a local store and on a (1, 16) mesh store,
    with hashed-token traffic of 1 ... 376 tokens per request."""
    import tempfile

    from repro_torch.api import PathResult
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.launch.serve_glm import make_traffic, serve_loop, smoke_check
    from repro_torch.obs import observe
    from repro_torch.serve import PathScorer, PathStore, RequestBatcher, StoreSnapshot

    L, p = path.betas.shape
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path.save(tmp)
        t_save = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        t0 = time.perf_counter()
        loaded = PathResult.load(tmp)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        same = torch.equal(loaded.betas, path.betas) and loaded.screen == path.screen
        print(f"[serve] checkpoint of the {L}-point path (p = {p}): {size} bytes, save "
              f"{t_save * 1e3:.1f} ms, load to the card {t_load * 1e3:.1f} ms; betas "
              f"{'bit-equal' if same else 'DIFFERENT'} -> {'ok' if same else 'MISMATCH'}")
        check(same, "PathResult.load did not give the saved path back")
        stores = {"local": PathStore.from_checkpoint(tmp),
                  f"mesh (1, {SPARSE_M})": PathStore.from_checkpoint(
                      tmp, mesh=make_dev_mesh(1, SPARSE_M), tile=SPARSE_OPTS["tile"])}
    t0 = time.perf_counter()
    count = SERVE_BATCH * (SERVE_ROUNDS + 1)
    reqs, lams = make_traffic(np.random.default_rng(19), p, count, path.lambdas,
                              tokens_per=SERVE_TOKENS)
    n_tok = sum(len(r) for r in reqs)
    print(f"[serve] traffic: {count} requests, {n_tok / count:.1f} tokens per request "
          f"(1 ... {SERVE_TOKENS}), tokens from [0, {4 * p}), lambdas uniform over the "
          f"{L} points; made in {time.perf_counter() - t0:.2f} s")
    launches, out = 0, {}
    for label, store in stores.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        scorer = PathScorer(store)
        batcher = RequestBatcher(p, max_batch=SERVE_BATCH, pad_p_to=store.pad_p_to)
        for r, lam in zip(reqs[:SERVE_BATCH], lams[:SERVE_BATCH]):
            batcher.submit(r, lam)
        warm, warm_lams = batcher.drain()
        scorer.score(warm, warm_lams)
        smoke_check(store, scorer, warm, warm.n_live, path)
        # the local store's rounds, swaps and stage timings under observe()
        with contextlib.ExitStack() as traced:
            obs = traced.enter_context(observe()) if label == "local" else None
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            engine.host_syncs = 0
            (total, secs, versions), sites, stacks = under_sync_debug(
                torch, lambda: serve_loop(scorer, batcher, reqs[SERVE_BATCH:], lams[SERVE_BATCH:],
                                          steps=SERVE_ROUNDS))
            counts = ops.launch_counts()
            syncs = engine.host_syncs
            print(f"[serve] {label}: {SERVE_ROUNDS} rounds, {total} scores in {secs:.3f} s -> "
                  f"{total / secs:,.1f} scores/s, {secs * 1e3 / SERVE_ROUNDS:.2f} ms per batch of "
                  f"{SERVE_BATCH}; versions {sorted(versions)}; launches {counts}; host reads "
                  f"{syncs}; synchronising calls by call site: {dict(sites)}; on {card}")
            check_sync_sites(sites, stacks, f"serve {label}")
            check(total == SERVE_ROUNDS * SERVE_BATCH, f"serve {label}: {total} scores served")
            check(counts["slab_path_spmv"] == SERVE_ROUNDS and counts["slab_spmv"] == 0,
                  f"serve {label}: expected one slab_spmv path-mode launch per batch, got {counts}")
            check(syncs == SERVE_ROUNDS, f"serve {label}: {syncs} host reads for "
                  f"{SERVE_ROUNDS} batches")
            launches += counts["slab_path_spmv"]
            stages = [serve_stage_times(torch, scorer, batcher, reqs[i * SERVE_BATCH:(i + 1) *
                                                                    SERVE_BATCH],
                                        lams[i * SERVE_BATCH:(i + 1) * SERVE_BATCH], card)
                      for i in range(1, 4)]
            med = {k: statistics.median(s[k] for s in stages) for k in stages[0]}
            print(f"[serve] {label}: one batch by stage (median of 3): host encode + pack "
                  f"{med['pack_ms']:.2f} ms, host->device copy {med['copy_ms']:.3f} ms "
                  f"({med['slab_bytes'] / 1e6:.1f} MB of request slab), slab_order "
                  f"{med['order_ms']:.3f} ms, kernel {med['kernel_ms']:.4f} ms "
                  f"({med['live']:.0f} live slots); staged device work {med['device_wall_ms']:.2f} "
                  f"ms of host wall; the scorer's whole call {med['score_ms']:.2f} ms; on {card}")
            # hot swap: a 2-point sub-path, the batch scored on the new version
            v0 = store.version
            sub = PathResult(lambdas=path.lambdas[:2], betas=path.betas[:2], nnz=path.nnz[:2],
                             f=path.f[:2], n_iters=path.n_iters[:2])
            store.swap(sub)
            got, v1 = scorer.score(warm, warm_lams)
            print(f"[serve] {label}: hot swap v{v0} -> v{v1}, {len(got)} scores")
            check(v1 == v0 + 1 and len(got) == warm.n_live and np.all(np.isfinite(got)),
                  f"serve {label}: the hot swap dropped the batch or its version")
            # a path with one NaN coefficient, where a request of the batch reads it
            bad = path.betas.clone()
            row = int(np.flatnonzero((warm.row_idx[:, 0] < warm.n_loc).any(-1))[0])
            i = int(warm.row_idx[row, 0, 0])
            lam_i = int(StoreSnapshot(0, path.lambdas, bad, p).indices_of(warm_lams)[i])
            bad[lam_i, row] = float("nan")
            store.swap(PathResult(lambdas=path.lambdas, betas=bad, nnz=path.nnz, f=path.f,
                                  n_iters=path.n_iters))
            again, v2 = scorer.score(warm, warm_lams)
            ok = v2 == v1 and store.quarantined == [v1 + 1] and np.array_equal(again, got)
            print(f"[serve] {label}: a version with one NaN coefficient (feature {row}, point "
                  f"{lam_i}, read by request {i}): quarantined {store.quarantined}, the batch "
                  f"rescored on v{v2} {'bit-equal' if np.array_equal(again, got) else 'DIFFERENT'}"
                  f" -> {'ok' if ok else 'MISMATCH'}")
            check(ok, f"serve {label}: the NaN version was not quarantined and rescored")
        if obs is not None:
            serve_report(obs, label, med, card)
        peak = torch.cuda.max_memory_allocated()
        print(f"[serve] {label}: peak device memory {peak / 1e9:.3f} GB (the stack "
              f"{store.snapshot.betas.numel() * 4 / 1e6:.1f} MB); on {card}")
        out[label] = dict(rate=total / secs, ms=secs * 1e3 / SERVE_ROUNDS, peak=peak, **med)
    out["save_ms"], out["load_ms"] = t_save * 1e3, t_load * 1e3
    return launches, out


# ---------------------------------------------------------------------------
# the chaos drills at full width: seeded faults on the cells above
# ---------------------------------------------------------------------------

#: points the killed path emits before it dies, and the resumed points run
#: under torch's sync debug mode (killed again after them)
CHAOS_KILL_AT, CHAOS_DEBUG_POINTS = 3, 2


def path_diff(a, b) -> list:
    """The fields in which two paths are not bit-equal: betas, lambdas, f,
    nnz, iterations, statuses, screen telemetry and metrics."""
    if len(a) != len(b):
        return ["length"]
    same = {"betas": a.betas.shape == b.betas.shape and bool((a.betas == b.betas).all()),
            "screen": a.screen == b.screen, "metrics": a.metrics == b.metrics}
    for key in ("lambdas", "f", "nnz", "n_iters", "statuses"):
        same[key] = np.array_equal(getattr(a, key), getattr(b, key))
    return [key for key, ok in same.items() if not ok]


def chaos_nan_inject(torch, ds, lam, base):
    """The dense cell's sequential fit with NaN margins at iteration 3
    (one solve), against phase 4's fit and a healthy fit cut at 3
    iterations."""
    from repro_torch.api import DenseDesign, LogisticL1
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.kernels import ops
    from repro_torch.resilience import EngineFault, FaultPlan, inject_faults

    opts = DGLMNETOptions(num_blocks=16, tile=128, max_iters=100, cycle_mode="sequential",
                          block=16)
    runs = {}
    for label, run_opts, plan in (
            ("tripped", opts, FaultPlan(engine=EngineFault("margins", at_iter=3),
                                        engine_fires=1)),
            ("cut", replace(opts, max_iters=3), None),
            ("again", opts, None)):
        ops.reset_launch_counts()
        s0, t0 = engine.host_syncs, time.perf_counter()
        with inject_faults(plan) if plan is not None else contextlib.nullcontext():
            res = LogisticL1(run_opts, device="cuda").fit(DenseDesign(ds.X_train),
                                                          ds.y_train, lam)
        torch.cuda.synchronize()
        runs[label] = (res, engine.host_syncs - s0, ops.launch_counts(),
                       (time.perf_counter() - t0) * 1e3)
    (bad, bad_reads, bad_counts, bad_ms), (_, cut_reads, cut_counts, _), \
        (again, _, again_counts, _) = runs["tripped"], runs["cut"], runs["again"]
    hist = bad.objective_history
    print(f"[chaos] nan-inject (dense cell, sequential, NaN margins at iteration 3): status "
          f"{bad.status_name}, {bad.n_iters} iterations, history {hist} (phase 4's first "
          f"{len(hist)}: {base.objective_history[:len(hist)]}), {bad_reads} host reads (a fit "
          f"cut at 3 iterations: {cut_reads}), launches {bad_counts} (cut: {cut_counts}), "
          f"{bad_ms:.1f} ms; a healthy fit after it bit-equal to phase 4's: "
          f"{torch.equal(again.beta, base.beta)}")
    check(bad.status_name == "NONFINITE_OBJECTIVE" and bad.n_iters == 2,
          f"nan-inject: {bad.status_name} after {bad.n_iters} iterations")
    check(bool(torch.isfinite(bad.beta).all()), "nan-inject: the returned beta is not finite")
    check(hist == base.objective_history[:len(hist)] and len(hist) == 3,
          "nan-inject: the history is not an exact prefix of phase 4's fit")
    check(torch.equal(again.beta, base.beta)
          and again.objective_history == base.objective_history,
          "nan-inject: the healthy fit after the fault differs from phase 4's")
    check(bad_reads == cut_reads == 4, f"nan-inject: {bad_reads} host reads, a fit cut at "
          f"3 iterations {cut_reads} (4 expected)")
    for name in ("logistic_stats", "gram_cd"):
        check(bad_counts[name] == cut_counts[name] > 0,
              f"nan-inject: {name} launched {bad_counts[name]} times, the cut fit "
              f"{cut_counts[name]}")
    launches = Counter()
    for _, _, counts, _ in runs.values():
        launches.update(counts)
    return launches


def chaos_kill_resume(torch, cell, path, path_walls, card):
    """Phase 8's sequential path, checkpointed at every point, killed after
    CHAOS_KILL_AT points, resumed for CHAOS_DEBUG_POINTS under sync debug
    mode and killed again, then resumed to its end: bit-equal to phase 8's
    result. Returns the launches, the walls and the progress directory's
    roll-back check."""
    import tempfile

    from repro_torch.api import LogisticL1, SlabDesign, estimator, make_design_eval
    from repro_torch.core import engine
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.obs import get_tracer
    from repro_torch.resilience import (FaultPlan, InjectedKill, PathProgress,
                                        corrupt_checkpoint, inject_faults)

    (rows, vals, y), (rt, vt, yt) = cell
    mesh = make_dev_mesh(1, SPARSE_M)
    design = SlabDesign(rows, vals, y.shape[0])
    opts = DGLMNETOptions(cycle_mode="sequential", **SPARSE_OPTS)
    evals = TimedEval(make_design_eval(SlabDesign(rt, vt, yt.shape[0]), yt, mesh=mesh,
                                       tile=opts.tile))
    est = LogisticL1(opts, mesh=mesh, device="cuda")
    saves, real_save = [], estimator._save_progress

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        nbytes = real_save(*args, **kw)
        # allow[torch-bench-timing]: a checkpoint is one counted host_array read, then file writes
        saves.append((nbytes, (time.perf_counter() - t0) * 1e3))
        return nbytes

    def killed_at(points, debug=False):
        def run():
            try:
                with inject_faults(FaultPlan(kill_after_points=points)):
                    est.path(design, y, path_len=PATH_LEN, eval_fn=evals, checkpoint_every=1,
                             resume_from=prog_dir)
            except InjectedKill:
                return True
            return False
        t0 = time.perf_counter()
        if debug:
            died, sites, stacks = under_sync_debug(torch, run)
        else:
            died, sites, stacks = run(), None, None
        torch.cuda.synchronize()
        return died, (time.perf_counter() - t0) * 1e3, sites, stacks

    estimator._save_progress = timed_save
    ops.reset_launch_counts()
    engine.host_syncs = 0
    tracer = get_tracer()                   # phase 8c's observe()
    first_span = len(tracer.spans)
    try:
        with tempfile.TemporaryDirectory() as prog_dir:
            died1, wall1, _, _ = killed_at(CHAOS_KILL_AT)
            died2, wall2, sites, stacks = killed_at(CHAOS_KILL_AT + CHAOS_DEBUG_POINTS,
                                                    debug=True)
            t0 = time.perf_counter()
            resumed = est.path(design, y, path_len=PATH_LEN, eval_fn=evals,
                               checkpoint_every=1, resume_from=prog_dir)
            torch.cuda.synchronize()
            wall3 = (time.perf_counter() - t0) * 1e3
            syncs = engine.host_syncs
            counts = ops.launch_counts()
            # the newest slot bit-flipped: the store rolls back to the one before
            prog = PathProgress(prog_dir)
            newest = prog.pointer()
            corrupt_checkpoint(prog.slot(newest), "bitflip", seed=newest)
            idx, _, meta = prog.load_latest()
    finally:
        estimator._save_progress = real_save
    diff = path_diff(resumed, path)
    want = path_walls["syncs"] + PATH_LEN + 2
    print(f"[chaos] kill-resume (webspam path cell, p = {rows.shape[0]}, sequential, "
          f"{PATH_LEN} points, checkpoint_every=1, eval included): killed after "
          f"{CHAOS_KILL_AT} points ({died1}) in {wall1:.1f} ms; resumed {CHAOS_DEBUG_POINTS} "
          f"points under sync debug mode, killed again ({died2}), {wall2:.1f} ms; resumed to "
          f"the end in {wall3:.1f} ms; in all {wall1 + wall2 + wall3:.1f} ms against the "
          f"uninterrupted path's {path_walls['wall_ms']:.1f} ms (phase 8); on {card}")
    print(f"[chaos] kill-resume: betas, lambdas, f, nnz, iterations, statuses, screen counts "
          f"and metrics {f'DIFFERENT in {diff}' if diff else 'bit-equal'} to phase 8's path; "
          f"host reads "
          f"{syncs} (phase 8's {path_walls['syncs']} + {PATH_LEN} checkpoints + 2 resumes' "
          f"lambda_max = {want}); synchronising calls of the resumed points under sync debug "
          f"mode, by call site: {dict(sites)}")
    print(f"[chaos] kill-resume: checkpoint per point (payload bytes, ms): "
          f"{[(b, round(ms, 1)) for b, ms in saves]}; median "
          f"{statistics.median(ms for _, ms in saves):.1f} ms, "
          f"{statistics.median(b for b, _ in saves):.0f} bytes; on {card}")
    print(f"[chaos] corrupt: the newest progress slot {newest} bit-flipped: load_latest rolled "
          f"back to slot {idx} (next_index {meta['next_index']})")
    splits = path_splits(tracer.spans[first_span:])
    for run, split in zip(("killed", "resumed and killed again", "resumed to the end"),
                          splits):
        print(f"[chaos] kill-resume, {run}, under observe(): {split_line(split)}; on {card}")
    totals = {name: sum(sp["phases"][name] for sp in splits) for name in PATH_PHASES}
    setup = sum(sp["setup_ms"] for sp in splits)
    other = sum(sp["point_other_ms"] for sp in splits)
    walls3 = sum(sp["wall_ms"] for sp in splits)
    print(f"[chaos] kill-resume split: the three runs' paths {walls3:.1f} ms against phase "
          f"8's uninterrupted {path_walls['wall_ms']:.1f} ms (untraced; its restricted solves {path_walls['solves_ms']:.1f} ms, its eval "
          f"{path_walls['eval_ms']:.1f} ms); the three runs' phases: "
          + ", ".join(f"{name} {ms:.1f} ms" for name, ms in totals.items())
          + f" (point_finish holds the {len(saves)} checkpoints, "
          f"{sum(ms for _, ms in saves):.1f} ms, and the eval), lambda_point outside its spans "
          f"{other:.1f} ms, paths outside their children (design wrap, residency build) "
          f"{setup:.1f} ms; on {card}")
    check(len(splits) == 3, f"kill-resume: {len(splits)} traced paths, expected 3")
    check(died1 and died2, "kill-resume: an injected kill did not fire")
    check(not diff, f"kill-resume: the resumed path differs from phase 8's in {diff}")
    check(syncs == want, f"kill-resume: {syncs} host reads, expected {want}")
    check_sync_sites(sites, stacks, "chaos resume")
    check(len(saves) == PATH_LEN, f"kill-resume: {len(saves)} checkpoints for {PATH_LEN} points")
    check(idx == newest - 1 and meta["next_index"] == newest,
          f"corrupt: load_latest gave slot {idx} after slot {newest} was bit-flipped")
    return counts, dict(killed_ms=wall1, debug_ms=wall2, resumed_ms=wall3, saves=saves)


def chaos_lost_bucket(torch, cell, stream, card):
    """Phase 8a's streamed cell (16 feature-range buckets from pinned host
    memory, the same budget, path_len 4): two lost puts retried, then a
    fatal window after half the puts, killed with checkpoints down and
    resumed on a new design from the same host buckets."""
    import tempfile

    from repro_torch.api import LogisticL1, SlabDesign, as_design, make_design_eval
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.resilience import FaultPlan, PathProgress, RetriesExhausted, inject_faults

    (_, _, y), (rt, vt, yt) = cell
    mesh = make_dev_mesh(1, SPARSE_M)
    opts = DGLMNETOptions(cycle_mode="sequential", **SPARSE_OPTS)
    base = stream["resident"]["res"]
    host_b, budget = stream["streamed"]["host_buckets"], stream["streamed"]["budget"]
    est = LogisticL1(opts, mesh=mesh, device="cuda")
    # phase 8a's eval, so that the metrics are compared too
    evals = make_design_eval(SlabDesign(rt, vt, yt.shape[0]), yt, mesh=mesh, tile=opts.tile)

    def design():
        return as_design(host_b, mesh=mesh, tile=opts.tile, device_budget_bytes=budget)

    ops.reset_launch_counts()
    des = design()
    t0 = time.perf_counter()
    with inject_faults(FaultPlan(fail_prefetches=2)):
        res = est.path(des, y, path_len=STREAM_PATH_LEN, eval_fn=evals)
    torch.cuda.synchronize()
    wall_t = (time.perf_counter() - t0) * 1e3
    (stats,) = des.residency_stats().values()
    diff_t = path_diff(res, base)
    after = stats["puts"] // 2
    with tempfile.TemporaryDirectory() as prog_dir:
        ckpt = dict(path_len=STREAM_PATH_LEN, eval_fn=evals, checkpoint_every=1,
                    resume_from=prog_dir)
        died = False
        t0 = time.perf_counter()
        try:
            with inject_faults(FaultPlan(fail_prefetches=3, fail_prefetches_after=after)):
                est.path(design(), y, **ckpt)
        except RetriesExhausted:
            died = True
        torch.cuda.synchronize()
        wall_f = (time.perf_counter() - t0) * 1e3
        landed = PathProgress(prog_dir).pointer()
        t0 = time.perf_counter()
        resumed = est.path(design(), y, **ckpt)
        torch.cuda.synchronize()
        wall_r = (time.perf_counter() - t0) * 1e3
    diff_r = path_diff(resumed, base)
    print(f"[chaos] lost-bucket transient (2 lost puts): {wall_t:.1f} ms against phase 8a's "
          f"streamed {stream['streamed']['wall_ms']:.1f} ms (+{wall_t - stream['streamed']['wall_ms']:.1f}"
          f" ms); residency {stats}; path {f'DIFFERENT in {diff_t}' if diff_t else 'bit-equal'}"
          f" to the resident one; on {card}")
    print(f"[chaos] lost-bucket fatal (3 lost puts after {after}): died with RetriesExhausted "
          f"({died}) in {wall_f:.1f} ms, the last checkpoint at point {landed}; resumed on a new "
          f"design in {wall_r:.1f} ms, {f'DIFFERENT in {diff_r}' if diff_r else 'bit-equal'} to "
          f"the resident path; on {card}")
    check(not diff_t, f"lost-bucket: the transient run differs from the resident path in {diff_t}")
    check(stats["retries"] == 2 and stats["evictions"] > 0 and stats["streamed"],
          f"lost-bucket: expected 2 retries and evictions, got {stats}")
    check(died, "lost-bucket: the fatal window did not kill the path")
    check(not diff_r, f"lost-bucket: the resumed path differs from the resident one in {diff_r}")
    return ops.launch_counts(), dict(transient_ms=wall_t, fatal_ms=wall_f, resumed_ms=wall_r,
                                     streamed_ms=stream["streamed"]["wall_ms"])


def chaos_corrupt(path):
    """Phase 8b's checkpoint, copied and damaged in each mode: the store
    must refuse it with a typed error."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointCorruption
    from repro_torch.resilience import RetriesExhausted, corrupt_checkpoint
    from repro_torch.serve import PathStore

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "path")
        path.save(src)
        for mode in ("bitflip", "truncate", "drop-meta"):
            d = os.path.join(tmp, mode)
            shutil.copytree(src, d)
            what = corrupt_checkpoint(d, mode, seed=20)
            try:
                PathStore.from_checkpoint(d, attempts=2)
            except (CheckpointCorruption, RetriesExhausted, ValueError) as err:
                cause = err.__cause__ if isinstance(err, RetriesExhausted) else None
                out[mode] = f"{type(err).__name__}" + (f" ({type(cause).__name__})"
                                                       if cause else "")
            else:
                fail(f"corrupt: a {mode} checkpoint loaded ({what})")
    print(f"[chaos] corrupt: phase 8b's checkpoint damaged three ways, each refused: {out}")


def chaos_overload(torch, path, card):
    """Phase 8b's path served from a local store under one failed swap and
    5 ms of latency per dispatch: a bounded queue, expired requests, a
    NaN version quarantined."""
    from repro_torch.api import PathResult
    from repro_torch.core import engine
    from repro_torch.kernels import ops
    from repro_torch.launch.serve_glm import make_traffic
    from repro_torch.resilience import FaultPlan, inject_faults
    from repro_torch.serve import (InvalidRequest, Overloaded, PathScorer, PathStore,
                                   RequestBatcher)

    L, p = path.betas.shape
    extra = 64
    reqs, lams = make_traffic(np.random.default_rng(20), p, 2 * SERVE_BATCH + extra,
                              path.lambdas, tokens_per=SERVE_TOKENS)
    ops.reset_launch_counts()
    with inject_faults(FaultPlan(fail_swaps=1, serve_latency_s=0.005)):
        store = PathStore(path)                 # the first publish fails, the retry lands
        scorer = PathScorer(store)
        t = [0.0]
        batcher = RequestBatcher(p, max_batch=SERVE_BATCH, pad_p_to=store.pad_p_to,
                                 max_pending=SERVE_BATCH, default_ttl_s=1.0,
                                 clock=lambda: t[0])
        rejected = 0
        for r, lam in zip(reqs[:SERVE_BATCH + extra], lams[:SERVE_BATCH + extra]):
            try:
                batcher.submit(r, lam)
            except Overloaded:
                rejected += 1
        try:
            batcher.submit({"x": float("inf")}, lams[0])
            fail("overload: a non-finite request was admitted")
        except InvalidRequest:
            pass
        t[0] = 2.0                              # every queued request expires
        shed, _ = batcher.drain()
        for r, lam in zip(reqs[SERVE_BATCH + extra:], lams[SERVE_BATCH + extra:]):
            batcher.submit(r, lam)
        batch, blams = batcher.drain()
        s0, c0 = engine.host_syncs, ops.launch_counts()["slab_path_spmv"]
        t0 = time.perf_counter()
        scores, ver = scorer.score(batch, blams)
        # allow[torch-bench-timing]: scorer.score ends in a counted host read of the scores
        ms = (time.perf_counter() - t0) * 1e3
        reads, launched = engine.host_syncs - s0, ops.launch_counts()["slab_path_spmv"] - c0
        store.swap(PathResult(lambdas=path.lambdas, betas=torch.full_like(path.betas, float("nan")),
                              nnz=path.nnz, f=path.f, n_iters=path.n_iters))
        s0, c0 = engine.host_syncs, ops.launch_counts()["slab_path_spmv"]
        again, ver2 = scorer.score(batch, blams)
        reads2, launched2 = engine.host_syncs - s0, ops.launch_counts()["slab_path_spmv"] - c0
    stats = batcher.stats
    ok = ver2 == ver and np.array_equal(again, scores) and store.quarantined == [ver + 1]
    print(f"[chaos] overload (local store, one failed swap, 5 ms per dispatch): version "
          f"{store.version}, {rejected} of {SERVE_BATCH + extra} rejected by the bounded queue, "
          f"{shed.n_live} live after the deadline; {len(scores)} scores in {ms:.2f} ms with "
          f"{launched} path-mode launch and {reads} host read; a NaN version quarantined "
          f"{store.quarantined}, the batch rescored on v{ver2} "
          f"{'bit-equal' if ok else 'DIFFERENT'} ({launched2} launches, {reads2} reads: the "
          f"NaN attempt and the rescore); batcher {stats}; on {card}")
    check(rejected == extra and shed.n_live == 0 and stats["shed_expired"] == SERVE_BATCH
          and stats["rejected_invalid"] == 1 and stats["drained"] == SERVE_BATCH,
          f"overload: admission or shedding went wrong: {stats}")
    check(len(scores) == SERVE_BATCH and np.all(np.isfinite(scores)),
          "overload: the batch was not scored")
    check(launched == reads == 1 and launched2 == reads2 == 2,
          f"overload: {launched} launches and {reads} reads for one batch")
    check(ok, "overload: the NaN version was not quarantined and the batch rescored")
    return ops.launch_counts()


def phase_chaos(torch, card, ds, lam, main_results, cell, path, path_walls, stream):
    """Phase 8c: the chaos drills on the cells of phases 4, 8, 8a and 8b,
    under the port's ``observe()``, every fault and retry counter held to
    what the drills inject."""
    from repro_torch.obs import observe

    t0 = time.perf_counter()
    launches = Counter()
    with observe() as obs:
        launches.update(chaos_nan_inject(torch, ds, lam, main_results["sequential"]))
        counts, kill = chaos_kill_resume(torch, cell, path, path_walls, card)
        launches.update(counts)
        counts, lost = chaos_lost_bucket(torch, cell, stream, card)
        launches.update(counts)
        chaos_corrupt(path)
        launches.update(chaos_overload(torch, path, card))
    counters = {k: v for k, v in obs.summary()["counters"].items()
                if k.startswith(("faults.", "retry.", "serve."))}
    want = {"faults.engine": 1, "faults.kill": 2, "faults.prefetch": 5, "faults.swap": 1,
            "faults.serve_delay": 3, "retry.retries": 7, "retry.exhausted": 3,
            "serve.swaps": 2}
    # allow[torch-bench-timing]: each drill ends in a counted host read or a synchronize of its own
    wall = time.perf_counter() - t0
    print(f"[chaos] counters under observe(): {counters}; expected {want}")
    print(f"[chaos] phase wall {wall:.1f} s; launches {dict(launches)}; on {card}")
    check(counters == want, f"chaos: the fault and retry counters {counters} != {want}")
    for name in ("logistic_stats", "gram_cd", "slab_gram", "slab_spmv", "slab_path_spmv"):
        check(launches[name] > 0, f"chaos: {name} was not launched")
    return dict(launches), dict(kill=kill, lost=lost, wall_s=wall)


# ---------------------------------------------------------------------------
# the LM serving cell: tinyllama-1.1b, batched prefill + greedy decode
# ---------------------------------------------------------------------------

LM_ARCH = "tinyllama-1.1b"
LM_BATCH, LM_PROMPT, LM_TOKENS = 8, 2048, 32
#: flash_attention against its plain version (tests/test_kernels.py's atol)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
#: bfloat16 output against the plain version's float32 result before its
#: cast, on every element: half a bf16 ulp (<= 2**-8 |o|) from the kernel's
#: one round-to-nearest cast, plus the float32 tolerance for the different
#: summation order. At S = 2048, |o| is about 0.03-0.06, so the reference's
#: 3e-2 alone would pass a wrong bf16 path (probabilities rounded to bf16,
#: a truncating cast); this bound does not.
FLASH_BF16_REL, FLASH_BF16_ABS = 2.0 ** -8, 2e-5
#: last prefill logits through the kernel against the plain chunked path,
#: bf16 model of 22 layers: the two attention paths round their bf16
#: outputs at different elements (one bf16 ulp), and the differences grow
#: through the residual stream; measured 0.068 at max |logit| 4.0, std 0.88
LM_LOGIT_TOL = 0.25
#: a zoo cell's last prefill logits through the kernel against the plain
#: chunked path, as a fraction of the plain logits' std: the drift grows
#: with the logits' scale, and a fixed 0.25 cannot hold where they are
#: large (the qwens' tied N(0, 1) embeddings give a std near 40). Set from
#: what was measured (chip_smoke.py and scripts/lm_logit_drift.py on an
#: H100): max err over std 0.075 tinyllama, 0.040 llama4, 0.084 internlm2,
#: 0.091 qwen2.5, 0.112 qwen1.5, about as far as the plain bf16 path lies
#: from float32 on the same weights. At std 0.88 (llama4, internlm2) the
#: bound is 0.22, inside LM_LOGIT_TOL
LM_LOGIT_STD_FRAC = 0.25
#: and the share of the 8 prompts whose next token (argmax) the two paths
#: agree on (measured 1.000 in every cell): at most one may flip
LM_ARGMAX_AGREE = 0.875
#: the float32 smoke model on the card against the CPU (tests/test_torch_lm.py)
LM_AGREE_TOL = 1e-4
#: the MoE and SSM serving cells (phases 15, 16): llama4-scout-17b-a16e at
#: full width cut to its first 4 of 48 layers (48 would be about 211 GB of
#: bf16 weights), mamba2-2.7b whole; the tinyllama cell's batch, prompt
#: and tokens
MOE_ARCH, MOE_LAYERS, SSM_ARCH = "llama4-scout-17b-a16e", 4, "mamba2-2.7b"
#: the MoE cell's attention (B, S, H, Hk, D): GQA group 5, D = 128
MOE_FLASH_SHAPE = (LM_BATCH, LM_PROMPT, 40, 8, 128)
#: a prefill of P tokens then one decode step against a prefill of P + 1,
#: the float32 smoke model (tests/test_models.py's SSD check, its atol;
#: tests/test_torch_mla.py holds MLA's absorbed decode to the same bound)
DECODE_TOL = 1e-4
#: the QKV-bias and GQA cells (phase 17): three dense configs whole, and
#: their attention (B, S, H, Hk, D) at GQA groups 8, 1 and 2, D = 128
DENSE_ARCHS = ("qwen2.5-3b", "qwen1.5-4b", "internlm2-1.8b")
DENSE_FLASH_SHAPES = {"qwen2.5-3b": (LM_BATCH, LM_PROMPT, 16, 2, 128),
                      "qwen1.5-4b": (LM_BATCH, LM_PROMPT, 20, 20, 128),
                      "internlm2-1.8b": (LM_BATCH, LM_PROMPT, 16, 8, 128)}
#: the MLA cell (phase 18): deepseek-v3-671b at full width, cut to its
#: first 4 of 61 layers (3 dense, 1 MoE) and without its MTP head, which
#: serving never reads (61 layers and the head are about 1.37 TB of bf16)
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 4


def flash_shapes():
    """(label, B, S, H, Hk, D): the serving cell's attention, one Hk == H
    shape, the reference's sweep shapes (tests/test_kernels.py), the
    sparse probe's chunk (phase 12a), the MoE cell's attention (phase
    15: GQA group 5, D = 128) and the dense cells' (phase 17: GQA groups 8,
    1 and 2, D = 128)."""
    return ([("cell", LM_BATCH, LM_PROMPT, 32, 4, 64), ("Hk == H", 2, 1024, 16, 16, 64),
             ("sweep", 1, 256, 2, 2, 64), ("sweep", 2, 512, 4, 4, 32),
             ("sweep", 1, 128, 1, 1, 128), ("probe", PROBE_CHUNK, PROBE_LEN, 32, 4, 64),
             ("moe cell", *MOE_FLASH_SHAPE)]
            + [(f"{arch} cell", *shape) for arch, shape in DENSE_FLASH_SHAPES.items()])


def phase_lm_kernels(torch, gen):
    """flash_attention against its plain version, float32 and bfloat16,
    causal and full; two launches bit-equal. Returns the error at the
    main path's case (the cell's shape, bfloat16, causal), and under
    ``"flash_attention (<label>)"`` each shape's bfloat16 causal error."""
    from repro_torch.kernels import ref
    flash_attention = import_module("repro_torch.kernels.flash_attention")

    cell_errs = {}
    for label, B, S, H, Hk, D in flash_shapes():
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, S, Hk, D, generator=gen, device="cuda").to(dt)
            tol = FLASH_TOL[str(dt).removeprefix("torch.")]
            for causal in (True, False):
                got = flash_attention.flash_attention_kernel(q, k, v, causal=causal)
                again = flash_attention.flash_attention_kernel(q, k, v, causal=causal)
                plain = ref.flash_attention_ref(q, k, v, causal=causal)
                e = max_err(got, plain)
                ulp = ""
                if dt == torch.bfloat16:
                    # the plain version's float32 result, before its cast
                    p32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                                  causal=causal)
                    ratio = float(((got.float() - p32).abs()
                                   / (FLASH_BF16_REL * p32.abs() + FLASH_BF16_ABS)).max())
                    ulp = (f", against the float32 plain result {ratio:.3g} of "
                           f"2^-8 |o| + {FLASH_BF16_ABS}")
                    e_ok = e <= tol and ratio <= 1.0
                    del p32
                else:
                    e_ok = e <= tol
                torch.cuda.synchronize()
                same = torch.equal(got, again)
                ok = e_ok and got.dtype == dt and got.shape == q.shape
                print(f"[lm-kernels] flash_attention {label} B={B} S={S} H={H} Hk={Hk} D={D} "
                      f"{str(dt).removeprefix('torch.')} {'causal' if causal else 'full'}: "
                      f"max abs err {e:.3g} (atol {tol}){ulp}, two launches "
                      f"{'bit-equal' if same else 'DIFFERENT'} -> {'ok' if ok and same else 'MISMATCH'}")
                check(ok, f"flash_attention {label} {dt} causal={causal} disagrees with its "
                          f"plain version")
                check(same, f"flash_attention {label} {dt} causal={causal}: two launches differ")
                if dt == torch.bfloat16 and causal:
                    cell_errs[label] = e
                del got, again, plain
            del q, k, v
    return {"flash_attention": cell_errs["cell"],
            **{f"flash_attention ({label})": e for label, e in cell_errs.items()}}


def phase_lm(torch, card):
    """The serving cell: tinyllama-1.1b at full width on the card."""
    from repro_torch.configs import MODEL_CONFIGS
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import decode, generate, greedy, prefill
    from repro_torch.models import init_params, param_bytes
    from repro_torch.train import make_prefill_step

    cfg = MODEL_CONFIGS[LM_ARCH]
    att = cfg.attention
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()          # by the earlier phases
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen,
                            device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    kv_bytes = (2 * cfg.num_layers * LM_BATCH * (LM_PROMPT + LM_TOKENS) * att.num_kv_heads
                * att.resolved_head_dim(cfg.d_model) * 2)
    print(f"[lm] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {att.num_heads}/{att.num_kv_heads} heads, "
          f"{n_params} parameters ({param_bytes(cfg) / 1e9:.2f} GB bf16) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s; batch {LM_BATCH} x {LM_PROMPT} prompt tokens + "
          f"{LM_TOKENS} greedy tokens; KV cache {kv_bytes / 1e6:.1f} MB")
    check(n_params == cfg.num_params(), "parameter count differs from count_params_analytic")
    # warm-up (cuBLAS handles, allocator pools), outside the counts
    generate(params, cfg, prompts, tokens=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    out, stats = generate(params, cfg, prompts, tokens=LM_TOKENS)
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    decode_ms = stats["decode_ms_per_token"]
    print(f"[lm] serve: prefill {stats['prefill_ms']:.2f} ms ({LM_BATCH * LM_PROMPT} prompt "
          f"tokens, {LM_BATCH * LM_PROMPT * 1e3 / stats['prefill_ms']:.0f} tokens/s), decode "
          f"{decode_ms:.3f} ms/token ({LM_BATCH * 1e3 / decode_ms:.0f} tokens/s at batch "
          f"{LM_BATCH}), whole generation {wall * 1e3:.1f} ms ({LM_BATCH * LM_TOKENS / wall:.0f} "
          f"generated tokens/s), peak device memory {peak:.2f} GB (weights and prompts included, "
          f"earlier phases' {held / 1e9:.2f} GB not), launches {counts}, on {card}")
    print(f"[lm] sample: {out[0, :16].tolist()}")
    check(tuple(out.shape) == (LM_BATCH, LM_TOKENS) and out.dtype == torch.int32,
          f"generated {tuple(out.shape)} {out.dtype}, expected ({LM_BATCH}, {LM_TOKENS}) int32")
    check(0 <= int(out.min()) and int(out.max()) < cfg.padded_vocab, "token ids out of range")
    check(counts["flash_attention"] == cfg.num_layers,
          f"flash_attention launched {counts['flash_attention']} times in one generation, "
          f"expected {cfg.num_layers} (once per layer in prefill, never in decode)")

    # prefill alone and one decode step alone
    ops.reset_launch_counts()
    logits_k, cache = prefill(params, cfg, prompts, LM_PROMPT + LM_TOKENS)
    n_prefill = ops.launch_counts()["flash_attention"]
    ops.reset_launch_counts()
    decode(params, cfg, cache, LM_PROMPT, greedy(logits_k), 1)
    n_decode = ops.launch_counts()["flash_attention"]
    del cache
    check(n_prefill == cfg.num_layers and n_decode == 0,
          f"launches: {n_prefill} in prefill (expected {cfg.num_layers}), {n_decode} in decode")
    # the kernel against the plain chunked path, through the whole model
    logits_p, _ = make_prefill_step(cfg, use_flash_kernel=False)(params, {"tokens": prompts})
    torch.cuda.synchronize()
    e = max_err(logits_k, logits_p)
    agree = float((logits_k[:, -1].argmax(-1) == logits_p[:, -1].argmax(-1)).float().mean())
    print(f"[lm] last prefill logits, kernel vs plain chunked attention: max abs err {e:.4g} "
          f"(tol {LM_LOGIT_TOL}; max |logit| {float(logits_p.float().abs().max()):.3g}, std "
          f"{float(logits_p.float().std()):.3g}), next-token argmax agreement {agree:.3f}")
    check(bool(torch.isfinite(logits_k.float()).all()), "prefill logits are not finite")
    check(e <= LM_LOGIT_TOL, f"prefill logits through the kernel differ from the plain "
                             f"path by {e}")
    del logits_k, logits_p
    # one host read for the whole generation
    _, sites, stacks = under_sync_debug(
        torch, lambda: generate(params, cfg, prompts, tokens=LM_TOKENS))
    print(f"[lm] synchronising calls in one generation (prefill + {LM_TOKENS - 1} decode "
          f"steps + fetch + reading the CUDA events), by call site: {dict(sites)}")
    if sum(sites.values()) != 1:
        for site, stack in stacks.items():
            print(f"[lm] synchronising call at {site}:\n{stack}")
    check(sum(sites.values()) == 1 and all(site.startswith("serve.py:") for site in sites),
          f"one generation made {sum(sites.values())} host reads: {dict(sites)}")
    return ({"flash_attention": counts["flash_attention"]},
            dict(stats, wall_s=wall, peak_gb=peak), (cfg, params, prompts))


def phase_lm_agree(torch, arch: str = LM_ARCH, tag: str = "lm-agree"):
    """The float32 smoke() model of ``arch`` with a 128-token prompt: card
    against CPU."""
    import copy

    from repro_torch.configs import MODEL_CONFIGS
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params
    from repro_torch.train import make_prefill_step

    cfg = MODEL_CONFIGS[arch].smoke()
    gen = torch.Generator().manual_seed(5)
    cpu = init_params(gen, cfg, device="cpu")
    # QKV biases start at zero, which would hide a missing bias add: draw them
    biases = [p for name, p in cpu.named_parameters() if name.endswith(("bq", "bk", "bv"))]
    with torch.no_grad():
        for p in biases:
            p.copy_(0.5 * torch.randn(p.shape, generator=gen))
    prompts = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, dtype=torch.int32)
    card = copy.deepcopy(cpu).to("cuda")
    prefill = make_prefill_step(cfg, use_flash_kernel=True)
    lc, _ = prefill(card, {"tokens": prompts.cuda()})
    lp, _ = prefill(cpu, {"tokens": prompts})
    tc, _ = generate(card, cfg, prompts.cuda(), tokens=8)
    tp, _ = generate(cpu, cfg, prompts, tokens=8)
    e = max_err(lc.cpu(), lp)
    bias = f", {len(biases)} QKV biases drawn from N(0, 0.25)" if biases else ""
    print(f"[{tag}] {cfg.name} float32{bias}, 2 x 128 prompt: card vs cpu last prefill logits "
          f"max abs err {e:.3g} (tol {LM_AGREE_TOL}); greedy tokens "
          f"{'equal' if torch.equal(tc, tp) else 'DIFFERENT'}: {tc[0].tolist()}")
    check(e <= LM_AGREE_TOL, f"card vs cpu prefill logits differ by {e}")
    check(torch.equal(tc, tp), f"card vs cpu greedy tokens differ: {tc.tolist()} vs {tp.tolist()}")


# ---------------------------------------------------------------------------
# the LM training cell: tinyllama-1.1b, AdamW, remat, 8 x 2048 tokens a step
# ---------------------------------------------------------------------------

#: 4 timed steps, so that the whole script, phases 17-18 included, keeps its time budget
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 2048, 4
#: the launcher's default --lr and corpus length (launch/train.py)
LM_TRAIN_LR, LM_TRAIN_CORPUS = 3e-4, 1_000_000
#: the card against the CPU, float32 smoke model (tests/test_torch_train.py)
LM_TRAIN_RTOL, LM_TRAIN_ATOL = 1e-4, 1e-5


def phase_lm_train(torch, card):
    """The training cell: tinyllama-1.1b at full width, one warm-up step and
    ``LM_TRAIN_STEPS`` timed steps through ``make_train_step``, on the card."""
    from repro_torch.configs import MODEL_CONFIGS
    from repro_torch.data.lm_data import batches, zipf_corpus
    from repro_torch.kernels import ops
    from repro_torch.models import forward
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import make_prefill_step, make_train_state, make_train_step

    flash_attention = import_module("repro_torch.kernels.flash_attention")
    cfg = MODEL_CONFIGS[LM_ARCH]
    check(cfg.remat and cfg.optimizer == "adamw" and cfg.param_dtype == "bfloat16",
          f"{cfg.name}: expected bf16 weights, AdamW and remat")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(torch.Generator(device="cuda").manual_seed(0), cfg,
                             device="cuda")
    n_params = sum(p.numel() for p in state["params"].parameters())
    total = LM_TRAIN_STEPS + 1
    step_fn = make_train_step(cfg, lr_schedule=warmup_cosine(LM_TRAIN_LR, max(total // 10, 1),
                                                             total))
    t0 = time.perf_counter()
    corpus = zipf_corpus(np.random.default_rng(0), cfg.vocab_size, LM_TRAIN_CORPUS)
    it = batches(corpus, LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg=cfg, rng=np.random.default_rng(0),
                 device="cuda")
    data = [next(it) for _ in range(total)]
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    # warm-up: step 0 of the schedule (lr 0), allocator pools and cuBLAS handles
    state, _ = step_fn(state, data[0])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(LM_TRAIN_STEPS + 1)]

    def run():
        nonlocal state
        out = []
        events[0].record()
        for i in range(LM_TRAIN_STEPS):
            state, m = step_fn(state, data[i + 1])
            events[i + 1].record()
            out.append(m)
        return out

    metrics, sites, stacks = under_sync_debug(torch, run)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(LM_TRAIN_STEPS)]
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    losses = torch.stack([m["loss"] for m in metrics]).cpu()
    gnorms = torch.stack([m["grad_norm"] for m in metrics]).cpu()
    lrs = torch.stack([m["lr"] for m in metrics]).cpu()
    ntok = int(metrics[0]["ntok"])
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    ms = statistics.mean(step_ms)
    # 6 N D for forward and backward, 2 N D for the remat forward (attention's
    # own score products not counted), at the bf16 dense peak
    flops = 8 * n_params * tokens
    bound = flops / BF16_FLOPS_PER_S * 1e3
    print(f"[lm-train] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} bf16 parameters, AdamW (float32 m, v), remat on, batch {LM_TRAIN_BATCH} "
          f"x {LM_TRAIN_SEQ} tokens ({ntok} labelled), warmup_cosine({LM_TRAIN_LR}, "
          f"{max(total // 10, 1)}, {total}); corpus and batches {t_data:.2f} s")
    print(f"[lm-train] losses {[round(float(x), 4) for x in losses]}, grad norms "
          f"{[round(float(x), 4) for x in gnorms]}, lr {[float(x) for x in lrs]}")
    print(f"[lm-train] step ms {[round(x, 2) for x in step_ms]}: mean {ms:.2f} ms, median "
          f"{statistics.median(step_ms):.2f} ms, {tokens * 1e3 / ms:.0f} tokens/s; bound "
          f"{bound:.2f} ms ({flops:.4g} FLOP at {BF16_FLOPS_PER_S:.4g} FLOP/s), share "
          f"{bound / ms:.4f}; peak device memory {peak:.2f} GB (earlier phases' "
          f"{held / 1e9:.2f} GB not included); launches {counts}; on {card}")
    print(f"[lm-train] synchronising calls in {LM_TRAIN_STEPS} steps, by call site: "
          f"{dict(sites)}")
    for site, stack in stacks.items():
        print(f"[lm-train] synchronising call at {site}:\n{stack}")
    check(bool(torch.isfinite(losses).all() and torch.isfinite(gnorms).all()),
          f"a training step's loss or grad norm is not finite: {losses}, {gnorms}")
    check(float(losses[-1]) < float(losses[0]),
          f"the loss did not fall: {float(losses[0])} -> {float(losses[-1])}")
    check(not sites, f"a training step synchronised: {dict(sites)}")
    check(counts["flash_attention"] == 0,
          f"flash_attention launched {counts['flash_attention']} times inside the steps")
    # the forward-only kernel refuses an operand that requires grad
    q = data[0]["tokens"].new_zeros((1, 128, 4, 64), dtype=torch.bfloat16).requires_grad_()
    refused = []
    for call in (lambda: flash_attention.flash_attention_kernel(q, q.detach(), q.detach()),
                 lambda: forward(state["params"], data[0], cfg, mode="train",
                                 use_flash_kernel=True)):
        try:
            call()
        except RuntimeError as err:
            refused.append("forward-only" in str(err))
    check(refused == [True, True] and ops.launch_counts()["flash_attention"] == 0,
          f"the flash kernel took an operand that requires grad: {refused}")
    del q
    # where a step's time goes: one more step (the schedule's step 9) profiled
    _, rows, busy, wall_ms = device_profile(torch, "lm train step",
                                            lambda: step_fn(state, data[-1]))
    report_profile("lm train step", f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens", rows, busy,
                   wall_ms, card)
    # the trained weights still serve through the kernel
    tokens_in = {"tokens": data[-1]["tokens"]}
    ops.reset_launch_counts()
    logits_k, _ = make_prefill_step(cfg, use_flash_kernel=True)(state["params"], tokens_in)
    n_flash = ops.launch_counts()["flash_attention"]
    logits_p, _ = make_prefill_step(cfg, use_flash_kernel=False)(state["params"], tokens_in)
    e = max_err(logits_k, logits_p)
    print(f"[lm-train] trained weights, last prefill logits through the kernel vs the plain "
          f"chunked path: max abs err {e:.4g} (tol {LM_LOGIT_TOL}; max |logit| "
          f"{float(logits_p.float().abs().max()):.3g}), {n_flash} flash_attention launches; "
          f"phase {time.perf_counter() - t_phase:.1f} s; on {card}")
    check(n_flash == cfg.num_layers, f"the trained weights' prefill launched flash_attention "
                                     f"{n_flash} times, expected {cfg.num_layers}")
    check(bool(torch.isfinite(logits_k.float()).all()) and e <= LM_LOGIT_TOL,
          f"trained weights: kernel prefill differs from the plain path by {e}")
    stats = {"ms": ms, "tokens_s": tokens * 1e3 / ms, "bound_ms": bound, "peak_gb": peak,
             "loss0": float(losses[0]), "loss_last": float(losses[-1])}
    del state, data, metrics, logits_k, logits_p
    torch.cuda.empty_cache()
    return stats


def phase_lm_train_agree(torch):
    """The float32 smoke() model trained 3 steps on the card and on the CPU
    from the same numpy weights and batches."""
    from repro_torch.api.convert import (train_state_from_reference,
                                         train_state_to_reference)
    from repro_torch.checkpoint.checkpointer import _flatten
    from repro_torch.configs import MODEL_CONFIGS
    from repro_torch.data.lm_data import zipf_corpus
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import make_train_state, make_train_step

    cfg = MODEL_CONFIGS[LM_ARCH].smoke()
    init = train_state_to_reference(make_train_state(torch.Generator().manual_seed(6), cfg,
                                                     device="cpu"))
    corpus = zipf_corpus(np.random.default_rng(6), cfg.vocab_size, 50_000)
    windows = [corpus[i * 4 * 129:(i + 1) * 4 * 129].reshape(4, 129) for i in range(3)]
    out = {}
    for dev in ("cuda", "cpu"):
        state = train_state_from_reference(init, cfg, device=dev)
        step = make_train_step(cfg, lr_schedule=warmup_cosine(1e-3, 1, 3))
        losses = []
        for w in windows:
            batch = {"tokens": torch.from_numpy(w[:, :-1].copy()).to(dev),
                     "labels": torch.from_numpy(w[:, 1:].copy()).to(dev)}
            state, m = step(state, batch)
            losses.append(m["loss"])
        out[dev] = (torch.stack(losses).cpu(), train_state_to_reference(state))
    (lc, sc), (lp, sp) = out["cuda"], out["cpu"]
    rel = float(((lc - lp).abs() / lp.abs()).max())
    worst, bad = 0.0, []
    for (path, a), (_, b) in zip(_flatten(sc), _flatten(sp)):
        worst = max(worst, float(np.abs(a.astype(np.float64) - b).max(initial=0.0)))
        if not np.allclose(a, b, rtol=LM_TRAIN_RTOL, atol=LM_TRAIN_ATOL):
            bad.append(path)
    print(f"[lm-train-agree] {cfg.name} float32, 3 steps of 4 x 128 tokens: card vs cpu "
          f"losses {[round(float(x), 6) for x in lc]} vs {[round(float(x), 6) for x in lp]} "
          f"(max rel diff {rel:.3g}, tol {LM_TRAIN_RTOL}); weights and moments max abs diff "
          f"{worst:.3g} (rtol {LM_TRAIN_RTOL}, atol {LM_TRAIN_ATOL}), outside: {bad}")
    check(rel <= LM_TRAIN_RTOL, f"card vs cpu training losses differ by {rel} relative")
    check(not bad, f"card vs cpu trained weights differ at {bad}")


# ---------------------------------------------------------------------------
# the LM zoo's serving cells: llama4-scout-17b-a16e (MoE) and mamba2-2.7b (SSD)
# ---------------------------------------------------------------------------


def bf16_spacing(x: float) -> float:
    """The gap between bf16 numbers at magnitude ``x``: 2^(e - 8) in
    [2^(e - 1), 2^e)."""
    return 2.0 ** (math.frexp(x)[1] - 8)


def flash_layers(cfg) -> int:
    """The attention layers of ``cfg`` whose prefill at ``LM_PROMPT`` tokens
    qualifies for the flash kernel (``models.attention.sdpa``'s test: no
    window, S a multiple of 128, q and v heads of one width): 0 for MLA,
    whose q head is ``qk_nope + qk_rope`` wide and v head ``v_head_dim``,
    and which the reference never routes to its kernel."""
    att = cfg.attention
    if att.use_mla or att.sliding_window or LM_PROMPT % 128:
        return 0
    return sum(kind in ("attn", "moe") for kind in cfg.layer_kinds())


def zoo_cell(torch, card, tag: str, cfg, cut: str, profile: bool = True):
    """Serve ``cfg`` on the card as phase 11 serves tinyllama: weights drawn
    on the card from seed 0, 8 prompts of 2048 tokens, 32 greedy tokens
    through ``launch.serve.generate``. Gates: one flash_attention launch
    per attention layer whose shape qualifies for the kernel
    (:func:`flash_layers`) in a generation (none in decode), the same in
    one prefill, whose logits are finite and (where any layer reaches the
    kernel) within ``LM_LOGIT_STD_FRAC`` of their std of the plain chunked
    path's, with the next token agreeing on ``LM_ARGMAX_AGREE`` of the
    prompts, and one
    host read per generation under sync debug mode. Prints the counts,
    weight bytes,
    prefill and decode times and peak memory, then (with ``profile``)
    profiles one prefill and 8 decode steps. Returns (flash launches in the timed generation,
    stats, (cfg, params, prompts))."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import count_params_analytic, forward, init_params, param_bytes
    from repro_torch.train import make_prefill_step

    n_attn = sum(kind in ("attn", "moe") for kind in cfg.layer_kinds())
    n_flash = flash_layers(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()          # by the earlier phases
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), generator=gen,
                            device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    total, active = count_params_analytic(cfg), cfg.num_active_params()
    print(f"[{tag}] {cfg.name} ({cut}): {cfg.num_layers} layers {cfg.layer_kinds()[:2]}..., "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), "
          f"{cfg.param_dtype}; {n_params} parameters, {w_bytes / 1e9:.3f} GB of weights "
          f"(param_bytes {param_bytes(cfg) / 1e9:.3f} GB), count_params_analytic {total}, "
          f"num_active_params {active}; drawn on the card in {t_init:.2f} s; batch {LM_BATCH} x "
          f"{LM_PROMPT} prompt tokens + {LM_TOKENS} greedy tokens; {n_attn} attention layers, "
          f"{n_flash} of them through the flash kernel")
    check(n_params == total, f"{tag}: {n_params} parameters, count_params_analytic {total}")
    # warm-up (cuBLAS handles, allocator pools), outside the counts
    generate(params, cfg, prompts, tokens=2)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    out, stats = generate(params, cfg, prompts, tokens=LM_TOKENS)
    wall = time.perf_counter() - t1
    counts = ops.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    decode_ms = stats["decode_ms_per_token"]
    print(f"[{tag}] serve: prefill {stats['prefill_ms']:.2f} ms ({LM_BATCH * LM_PROMPT} prompt "
          f"tokens, {LM_BATCH * LM_PROMPT * 1e3 / stats['prefill_ms']:.0f} tokens/s), decode "
          f"{decode_ms:.3f} ms/token ({LM_BATCH * 1e3 / decode_ms:.0f} tokens/s at batch "
          f"{LM_BATCH}), whole generation {wall * 1e3:.1f} ms, peak device memory {peak:.2f} GB "
          f"(weights and prompts included, earlier phases' {held / 1e9:.2f} GB not), launches "
          f"{counts}, on {card}")
    print(f"[{tag}] sample: {out[0, :16].tolist()}")
    check(tuple(out.shape) == (LM_BATCH, LM_TOKENS) and out.dtype == torch.int32,
          f"{tag}: generated {tuple(out.shape)} {out.dtype}")
    check(0 <= int(out.min()) and int(out.max()) < cfg.padded_vocab,
          f"{tag}: token ids out of range")
    check(counts["flash_attention"] == n_flash,
          f"{tag}: flash_attention launched {counts['flash_attention']} times in one "
          f"generation, expected {n_flash} (once per attention layer whose shape qualifies, in "
          f"prefill; never in decode)")

    # one prefill through the kernel, with the layers' aux, against the plain path
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, _, aux = forward(params, {"tokens": prompts}, cfg, mode="prefill",
                                 use_flash_kernel=True)
    n_prefill = ops.launch_counts()["flash_attention"]
    finite = bool(torch.isfinite(logits).all())
    last_k = logits[:, -1].clone()
    del logits
    aux = {k: float(v) for k, v in aux.items()}
    print(f"[{tag}] one prefill: {n_prefill} flash_attention launches, logits finite {finite}, "
          f"aux {aux}")
    check(n_prefill == n_flash, f"{tag}: {n_prefill} flash launches in a prefill, not {n_flash}")
    check(finite, f"{tag}: prefill logits are not finite")
    if n_flash:
        logits_p, _ = make_prefill_step(cfg, use_flash_kernel=False)(params,
                                                                     {"tokens": prompts})
        last_p = logits_p[:, -1].clone()
        del logits_p
        e = max_err(last_k, last_p)
        diff = (last_k.float() - last_p.float()).abs()
        at = float(last_p.flatten()[int(diff.argmax())].float())
        agree = float((last_k.argmax(-1) == last_p.argmax(-1)).float().mean())
        std = float(last_p.float().std())
        tol = LM_LOGIT_STD_FRAC * std
        print(f"[{tag}] last prefill logits, kernel vs plain chunked attention: max abs err "
              f"{e:.4g} (tol {tol:.4g}: {LM_LOGIT_STD_FRAC} of the plain logits' std "
              f"{std:.4g}; err {e / std:.4f} std; at a plain logit of {at:.4g}, "
              f"{e / bf16_spacing(abs(at)):.1f} bf16 spacings there; max |logit| "
              f"{float(last_p.float().abs().max()):.3g}), next-token argmax agreement {agree:.3f} "
              f"(at least {LM_ARGMAX_AGREE})")
        check(e <= tol, f"{tag}: prefill logits through the kernel differ from the plain path "
                        f"by {e} (tol {tol}: {LM_LOGIT_STD_FRAC} std)")
        check(agree >= LM_ARGMAX_AGREE, f"{tag}: the kernel's and the plain path's next tokens "
                                        f"agree on {agree} of the prompts")
        del last_p
    del last_k
    # one host read for the whole generation
    _, sites, stacks = under_sync_debug(
        torch, lambda: generate(params, cfg, prompts, tokens=LM_TOKENS))
    print(f"[{tag}] synchronising calls in one generation, by call site: {dict(sites)}")
    if sum(sites.values()) != 1:
        for site, stack in stacks.items():
            print(f"[{tag}] synchronising call at {site}:\n{stack}")
    check(sum(sites.values()) == 1 and all(site.startswith("serve.py:") for site in sites),
          f"{tag}: one generation made {sum(sites.values())} host reads: {dict(sites)}")
    if profile:
        profile_prefill(torch, (cfg, params, prompts), card, label=tag)
    return (counts["flash_attention"], dict(stats, wall_s=wall, peak_gb=peak, aux=aux),
            (cfg, params, prompts))


def phase_lm_moe(torch, card):
    """Phase 15: llama4-scout-17b-a16e at full width, its first
    ``MOE_LAYERS`` layers; its float32 smoke model card against CPU; the
    kernel alone at the cell's attention shape (row 6b)."""
    from repro_torch.configs import MODEL_CONFIGS
    from repro_torch.models.moe import capacity

    t0 = time.perf_counter()
    full = MODEL_CONFIGS[MOE_ARCH]
    cfg = replace(full, num_layers=MOE_LAYERS)
    att, moe = cfg.attention, cfg.moe
    check((att.num_heads, att.num_kv_heads, att.head_dim) == MOE_FLASH_SHAPE[2:],
          f"{cfg.name}: attention {att} is not the sweep's MoE shape {MOE_FLASH_SHAPE}")
    launches, stats, inputs = zoo_cell(
        torch, card, "lm-moe", cfg,
        f"depth cut to {MOE_LAYERS} of {full.num_layers} layers; {moe.num_experts} experts "
        f"of {moe.expert_d_ff}, top-{moe.top_k}, {moe.num_shared_experts} shared, capacity "
        f"factor {moe.capacity_factor}; {att.num_heads}/{att.num_kv_heads} heads of "
        f"{att.head_dim}")
    drop = stats["aux"]["moe_drop_frac"]
    print(f"[lm-moe] one prefill's moe_drop_frac: {drop:.6f} summed over the {MOE_LAYERS} "
          f"layers as the reference sums it ({drop / MOE_LAYERS:.6f} a layer at capacity "
          f"{capacity(LM_BATCH * LM_PROMPT, moe)} per expert), moe_lb_loss "
          f"{stats['aux']['moe_lb_loss']:.6g}, moe_z_loss "
          f"{stats['aux']['moe_z_loss']:.6g}")
    del inputs
    torch.cuda.empty_cache()
    phase_lm_agree(torch, MOE_ARCH, "lm-moe-agree")
    # row 6b: the kernel alone at the cell's attention shape
    flush = torch.empty(256 * 2 ** 20, device="cuda")
    row = flash_time_row(torch, *MOE_FLASH_SHAPE)
    ms, plain_ms, library_ms, b_ms, b_by = time_row(torch, row, flush, card,
                                                    label="flash_attention (moe cell, row 6b)")
    print(f"[times] flash_attention (moe cell, row 6b): {launches} launches in the cell's "
          f"generation, {b_ms / ms:.3f} of its bound, {library_ms / ms:.3f} of SDPA's time")
    del row, flush
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[lm-moe] phase wall {wall:.1f} s; on {card}")
    return launches, dict(stats, row6b=(ms, plain_ms, library_ms, b_ms, b_by), phase_s=wall)


def decode_check(torch, arch: str, tag: str):
    """The float32 smoke model of ``arch`` on the card: a prefill of 128
    tokens spliced into a cache, then one decode step (MLA's absorbed
    form, the SSD's state update), against a prefill of the 129 tokens at
    the last position."""
    from repro_torch.configs import MODEL_CONFIGS
    from repro_torch.launch.serve import prefill
    from repro_torch.models import forward, init_params

    cfg = MODEL_CONFIGS[arch].smoke()
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = init_params(gen, cfg, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 129), generator=gen, device="cuda",
                         dtype=torch.int32)
    with torch.no_grad():
        full, _, _ = forward(params, {"tokens": toks}, cfg, mode="prefill")
        _, cache = prefill(params, cfg, toks[:, :128], 129)
        dec, _, _ = forward(params, {"tokens": toks[:, 128:]}, cfg, mode="decode", cache=cache,
                            cache_index=128)
    e = max_err(dec[:, 0], full[:, 128])
    print(f"[{tag}] {cfg.name} float32 on the card: prefill of 128 tokens then one "
          f"decode step vs a prefill of 129, last logits max abs err {e:.3g} (tol "
          f"{DECODE_TOL})")
    check(e <= DECODE_TOL, f"{cfg.name}: decode after prefill differs by {e} from the "
                           f"longer prefill")


def phase_lm_ssm(torch, card):
    """Phase 16: mamba2-2.7b whole; its float32 smoke model card against
    CPU; prefill-then-decode against the longer prefill."""
    from repro_torch.configs import MODEL_CONFIGS

    t0 = time.perf_counter()
    cfg = MODEL_CONFIGS[SSM_ARCH]
    ssm = cfg.ssm
    launches, stats, inputs = zoo_cell(
        torch, card, "lm-ssm", cfg,
        f"not cut; {ssm.num_heads(cfg.d_model)} SSD heads of {ssm.head_dim}, d_state "
        f"{ssm.d_state}, chunk {ssm.chunk_size}, tied embeddings")
    del inputs
    torch.cuda.empty_cache()
    phase_lm_agree(torch, SSM_ARCH, "lm-ssm-agree")
    decode_check(torch, SSM_ARCH, "lm-ssm-agree")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[lm-ssm] phase wall {wall:.1f} s; on {card}")
    return launches, dict(stats, phase_s=wall)


def phase_lm_dense(torch, card, flush):
    """Phase 17: the QKV-bias and GQA cells, qwen2.5-3b, qwen1.5-4b and
    internlm2-1.8b, each whole through :func:`zoo_cell` (the first of them
    profiled: the three share one layer design) and its float32
    smoke model (non-zero biases) card against CPU; then the kernel alone
    at each cell's attention shape (rows 6c-6e). Returns {arch: (flash
    launches in the cell's generation, stats, timing row)}."""
    from repro_torch.configs import MODEL_CONFIGS

    out = {}
    for row, arch in zip("cde", DENSE_ARCHS):
        t0 = time.perf_counter()
        cfg = MODEL_CONFIGS[arch]
        att = cfg.attention
        shape = DENSE_FLASH_SHAPES[arch]
        check((att.num_heads, att.num_kv_heads, att.head_dim) == shape[2:],
              f"{arch}: attention {att} is not the dense cell's shape {shape}")
        launches, stats, inputs = zoo_cell(
            torch, card, "lm-dense", cfg,
            f"not cut; {att.num_heads}/{att.num_kv_heads} heads of {att.head_dim} (GQA group "
            f"{att.num_heads // att.num_kv_heads}), QKV bias {att.qkv_bias}, rope theta "
            f"{att.rope_theta:g}, {'tied' if cfg.tie_embeddings else 'untied'} embeddings",
            profile=arch == DENSE_ARCHS[0])
        del inputs
        torch.cuda.empty_cache()
        phase_lm_agree(torch, arch, "lm-dense-agree")
        label = f"flash_attention ({arch} cell, row 6{row})"
        timing = time_row(torch, flash_time_row(torch, *shape), flush, card, label=label)
        ms, _, library_ms, b_ms, _ = timing
        print(f"[times] {label}: {launches} launches in the cell's generation, "
              f"{b_ms / ms:.3f} of its bound, {library_ms / ms:.3f} of SDPA's time")
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[lm-dense] {arch}: cell wall {wall:.1f} s; on {card}")
        out[arch] = (launches, dict(stats, phase_s=wall), timing)
    return out


def phase_lm_mla(torch, card):
    """Phase 18: deepseek-v3-671b at full width, cut to its first
    ``MLA_LAYERS`` layers and without the MTP head, through
    :func:`zoo_cell` (no layer reaches the flash kernel); its float32
    smoke model (MTP head kept) card against CPU; the absorbed decode
    after a prefill against the longer prefill."""
    from repro_torch.configs import MODEL_CONFIGS
    from repro_torch.models.moe import capacity

    t0 = time.perf_counter()
    full = MODEL_CONFIGS[MLA_ARCH]
    cfg = replace(full, num_layers=MLA_LAYERS, mtp_depth=0)
    att, moe = cfg.attention, cfg.moe
    n_dense = cfg.layer_kinds().count("attn")
    launches, stats, inputs = zoo_cell(
        torch, card, "lm-mla", cfg,
        f"depth cut to {MLA_LAYERS} of {full.num_layers} layers ({n_dense} dense, "
        f"{MLA_LAYERS - n_dense} MoE); the MTP head ({full.mtp_depth} MoE layer and its "
        f"projection, training only) cut; MLA: {att.num_heads} heads, q_lora "
        f"{att.q_lora_rank}, kv_lora {att.kv_lora_rank}, rope {att.qk_rope_head_dim}, nope "
        f"{att.qk_nope_head_dim}, v {att.v_head_dim}; {moe.num_experts} experts of "
        f"{moe.expert_d_ff}, top-{moe.top_k}, {moe.num_shared_experts} shared, capacity factor "
        f"{moe.capacity_factor}; dense d_ff {cfg.d_ff}")
    del inputs
    torch.cuda.empty_cache()
    drop, n_moe = stats["aux"]["moe_drop_frac"], MLA_LAYERS - n_dense
    latent_bytes = (2 * MLA_LAYERS * LM_BATCH * (LM_PROMPT + LM_TOKENS)
                    * (att.kv_lora_rank + att.qk_rope_head_dim))
    print(f"[lm-mla] one prefill's moe_drop_frac: {drop:.6f} summed over the {n_moe} MoE "
          f"layers as the reference sums it ({drop / n_moe:.6f} a layer at capacity "
          f"{capacity(LM_BATCH * LM_PROMPT, moe)} per expert), moe_lb_loss "
          f"{stats['aux']['moe_lb_loss']:.6g}, moe_z_loss {stats['aux']['moe_z_loss']:.6g}; "
          f"the bf16 latent and rope caches {latent_bytes / 1e6:.1f} MB in all")
    phase_lm_agree(torch, MLA_ARCH, "lm-mla-agree")
    decode_check(torch, MLA_ARCH, "lm-mla-agree")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[lm-mla] phase wall {wall:.1f} s; on {card}")
    return launches, dict(stats, phase_s=wall)


# ---------------------------------------------------------------------------
# the paper's comparison: truncated gradient, Table 3, Figure 1, the
# ablation and the sparse probe, on the epsilon cell and tinyllama
# ---------------------------------------------------------------------------

#: tg_pass against its plain version: (machines, steps, p, theta); the
#: first is the epsilon cell's (its first 16 x 2048 rows), the second wide,
#: its rows not 16-byte aligned (the kernel's cp.async path) and with a
#: finite theta, so that the truncation's where bites, the third the
#: widest the kernel takes
TG_SHAPES = ((16, 2048, 2000, float("inf")), (4, 1000, 4099, 0.05),
             (2, 500, 8192, float("inf")))
#: the dependent latency of one tg_pass step at p = 2000 (a dot reduced to
#: a value every thread holds, a sigmoid, one update), summed from the
#: latencies that scripts/tg_step_probe.cu measures on an H100 (NVIDIA
#: H100 80GB HBM3, 700 W): the least step, with the hardware exp and one
#: division (the chain bound), and this design's chain, with the float
#: sigmoid the host repeats bit for bit
TG_LEAST_NS_PER_STEP = 158.6
TG_CHAIN_NS_PER_STEP = 172.0
#: the TG fit on the card against the CPU's: rows of the epsilon cell, passes
TG_AGREE_ROWS, TG_AGREE_PASSES = 8192, 3
PROBE_PROMPTS, PROBE_LEN, PROBE_CHUNK, PROBE_MARKER = 2048, 128, 256, 7
PROBE_PATH_LEN = 8
PROBE_OPTS = dict(num_blocks=4, tile=32, max_iters=40)     # examples/sparse_probe.py


def tg_checks(torch, ds, gravity: float):
    """tg_pass against tg_pass_ref on the card at TG_SHAPES, bit for bit
    (the plain version repeats the kernel's sum order and float sigmoid op
    for op); two launches bit-equal. The cell's whole pass is held to its
    plain version in tg_time_row."""
    from repro_torch.core.truncated_gradient import shrink as tg_shrink
    from repro_torch.kernels import ref, tg_pass

    gen = torch.Generator(device="cuda").manual_seed(22)
    eta = 0.1
    shrink = tg_shrink(eta, gravity)
    for M, S, p, theta in TG_SHAPES:
        if p == ds.X_train.shape[1]:
            Xs = ds.X_train[:M * S].view(M, S, p)
            ys = ds.y_train[:M * S].view(M, S)
        else:
            Xs = torch.randn(M, S, p, generator=gen, device="cuda")
            ys = torch.where(torch.rand(M, S, generator=gen, device="cuda") < 0.5, 1.0, -1.0)
        beta0 = 0.01 * torch.randn(p, generator=gen, device="cuda")
        got = tg_pass.tg_pass_kernel(Xs, ys, beta0, eta, shrink, theta)
        again = tg_pass.tg_pass_kernel(Xs, ys, beta0, eta, shrink, theta)
        plain = ref.tg_pass_ref(Xs, ys, beta0, eta, shrink, theta)
        torch.cuda.synchronize()
        e = max_err(got, plain)
        ok = torch.allclose(got, plain, atol=TOL, rtol=TOL)
        bits = torch.equal(got, plain)
        same = torch.equal(got, again)
        print(f"[paper] tg_pass M={M} steps={S} p={p} theta={theta}: max abs err {e:.3g} "
              f"(atol = rtol = {TOL}; bit-equal to the plain version: {bits}), two launches "
              f"{'bit-equal' if same else 'DIFFERENT'}, max |beta| {float(got.abs().max()):.3g} "
              f"-> {'ok' if ok and bits and same else 'MISMATCH'}")
        check(ok, f"tg_pass M={M} p={p} disagrees with its plain version by {e}")
        check(bits, f"tg_pass M={M} p={p} is not bit-equal to its plain version")
        check(same, f"tg_pass M={M} p={p}: two launches differ")


def tg_agreement(torch, ds):
    """A TG fit on the card against the same fit on the CPU (plain
    versions), and no synchronising call inside a card fit."""
    from repro_torch.core.objective import lambda_max
    from repro_torch.core.truncated_gradient import TGOptions, truncated_gradient_fit

    X, y = ds.X_train[:TG_AGREE_ROWS], ds.y_train[:TG_AGREE_ROWS]
    lam = float(lambda_max(X, y)) / 16
    opts = TGOptions(num_machines=16, passes=TG_AGREE_PASSES)
    card = truncated_gradient_fit(X, y, lam, opts=opts, device="cuda")
    t0 = time.perf_counter()
    cpu = truncated_gradient_fit(X.cpu(), y.cpu(), lam, opts=opts, device="cpu")
    # allow[torch-bench-timing]: times a fit on the CPU (device='cpu'); no CUDA work in between
    t_cpu = time.perf_counter() - t0
    for (k, a), (_, b) in zip(card, cpu):
        a = a.cpu()
        close = torch.allclose(a, b, rtol=1e-4, atol=1e-6)
        print(f"[paper] tg fit {TG_AGREE_ROWS}x{X.shape[1]} pass {k}: card vs cpu max |dbeta| "
              f"{max_err(a, b):.3g} (rtol 1e-4, atol 1e-6; bit-equal {torch.equal(a, b)}), "
              f"max |beta| {float(b.abs().max()):.3g}; cpu fit {t_cpu:.1f} s")
        check(close, f"TG pass {k}: card and cpu betas disagree beyond rtol 1e-4 / atol 1e-6")
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, sites, stacks = under_sync_debug(torch, lambda: truncated_gradient_fit(
        X, y, lam, opts=opts, generator=gen, device="cuda"))
    for site, stack in stacks.items():
        print(f"[paper] synchronising call at {site}:\n{stack}")
    print(f"[paper] synchronising calls in a shuffled {TG_AGREE_PASSES}-pass card TG fit "
          f"(sync debug mode): {dict(sites)}")
    check(not sites, f"truncated_gradient_fit synchronised: {dict(sites)}")


def probe_phase(torch, card, lm_inputs):
    """The sparse probe on tinyllama-1.1b at full width: features in chunks
    through the flash kernel, then a probe path on a 4/5 split."""
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.core.probe import extract_features, probe_path
    from repro_torch.kernels import ops
    from repro_torch.paper.common import make_device_eval

    cfg, params, _ = lm_inputs
    rng = np.random.default_rng(0)
    tokens = rng.integers(8, cfg.vocab_size, (PROBE_PROMPTS, PROBE_LEN))
    has = rng.random(PROBE_PROMPTS) < 0.5
    pos = rng.integers(0, PROBE_LEN, PROBE_PROMPTS)
    tokens[has, pos[has]] = PROBE_MARKER
    tok = torch.from_numpy(tokens.astype(np.int32)).cuda()
    y = torch.from_numpy(np.where(has, 1.0, -1.0).astype(np.float32)).cuda()
    feats, flash = [], []
    t0 = time.perf_counter()
    for lo in range(0, PROBE_PROMPTS, PROBE_CHUNK):
        ops.reset_launch_counts()
        feats.append(extract_features(params, cfg, tok[lo:lo + PROBE_CHUNK],
                                      use_flash_kernel=True))
        flash.append(ops.launch_counts()["flash_attention"])
    F = torch.cat(feats).float()
    torch.cuda.synchronize()
    t_feat = time.perf_counter() - t0
    finite = bool(torch.isfinite(F).all())
    print(f"[paper] probe features: {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, bf16) over {PROBE_PROMPTS} prompts of {PROBE_LEN} tokens in chunks "
          f"of {PROBE_CHUNK}: {t_feat * 1e3:.1f} ms, flash_attention launches per chunk "
          f"{flash}, finite {finite}, on {card}")
    check(all(c == cfg.num_layers for c in flash),
          f"flash_attention launched {flash} times per chunk, expected {cfg.num_layers}")
    check(finite and tuple(F.shape) == (PROBE_PROMPTS, cfg.d_model),
          f"probe features {tuple(F.shape)} not finite or misshaped")
    F = (F - F.mean(0)) / (F.std(0) + 1e-6)
    n_train = PROBE_PROMPTS * 4 // 5
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    pts = probe_path(F[:n_train], y[:n_train], path_len=PROBE_PATH_LEN,
                     opts=DGLMNETOptions(**PROBE_OPTS),
                     eval_fn=make_device_eval(F[n_train:], y[n_train:]), device="cuda")
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t1
    counts = ops.launch_counts()
    for i, pt in enumerate(pts):
        print(f"[paper] probe point {i}: lam {pt.lam:.4f} nnz {pt.nnz} status "
              f"{pt.status} iters {pt.n_iters} test AUPRC {pt.metrics['auprc']:.4f} "
              f"accuracy {pt.metrics['accuracy']:.4f}")
    print(f"[paper] probe path: {len(pts)} points on {n_train} x {cfg.d_model} in "
          f"{t_path * 1e3:.1f} ms, launches {counts}, on {card}")
    check(len(pts) == PROBE_PATH_LEN and all(pt.ok for pt in pts),
          f"probe path points not all OK: {[pt.status for pt in pts]}")
    check(counts["gram_cd"] > 0 and counts["logistic_stats"] > 0,
          f"the probe path launched {counts}")
    return {"features_ms": t_feat * 1e3, "path_ms": t_path * 1e3, "flash": sum(flash),
            "path_launches": counts, "best_auprc": max(pt.metrics["auprc"] for pt in pts)}


def phase_paper(torch, card, ds, lm_inputs):
    """The paper's comparison on the card: tg_pass against its plain
    version, the TG fit card-vs-CPU and under sync debug mode, Table 3 and
    Figure 1 on the epsilon cell at full width, the ablation at its own
    shape, the sparse probe on tinyllama. Returns (the launches of the
    driven paths, a summary)."""
    from repro_torch.core.objective import lambda_max
    from repro_torch.kernels import ops
    from repro_torch.paper import ablation_parallel_cd, fig1_quality_sparsity, table3_timing

    t_phase = time.perf_counter()
    X, y = ds.X_train, ds.y_train
    lmax = float(lambda_max(X, y))
    tg_checks(torch, ds, lmax / 16 / X.shape[0])
    tg_agreement(torch, ds)
    launches = Counter()

    ops.reset_launch_counts()
    t3 = table3_timing.run_dataset("glm-epsilon", X, y, "cuda")
    counts = ops.launch_counts()
    launches.update(counts)
    print(f"[paper] table3 glm-epsilon {tuple(X.shape)}: d-GLMNET {t3['iters']} iterations "
          f"({t3['status']}) at lambda_max/64 = {t3['lam']:.4f}, {t3['iter_ms']:.3f} ms per "
          f"iteration, line search {t3['ls_ms']:.3f} ms (CUDA events, share "
          f"{t3['ls_share']:.3f}); truncated gradient {t3['tg_pass_ms']:.3f} ms per pass "
          f"(16 machines); launches {counts}; on {card}")
    check(t3["status"] == "OK", f"table3 fit tripped {t3['status']}")
    check(counts["tg_pass"] == 1 + table3_timing.TG_PASSES,
          f"table3's TG fits launched tg_pass {counts['tg_pass']} times")

    fig = fig1_quality_sparsity
    ops.reset_launch_counts()
    rows, fsum = fig.run_dataset("glm-epsilon", X, y, ds.X_test, ds.y_test, "cuda")
    counts = ops.launch_counts()
    launches.update(counts)
    for pt in fsum["path"]:
        print(f"[paper] fig1 d-GLMNET lam {pt.lam:.4f}: nnz {pt.nnz} AUPRC "
              f"{pt.metrics['auprc']:.4f} status {pt.status} iters {pt.n_iters}")
    for div in fig.TG_LAM_DIVS:
        for lr in fig.TG_LRS:
            best = max((r for r in rows if r[1] == f"tg(lr={lr})"
                        and r[2].startswith(f"{lmax / div:.4g}@")), key=lambda r: r[4])
            last = [r for r in rows if r[1] == f"tg(lr={lr})"
                    and r[2] == f"{lmax / div:.4g}@p{fig.TG_PASSES}"][0]
            print(f"[paper] fig1 TG lambda_max/{div} lr {lr}: pass {fig.TG_PASSES} nnz {last[3]} "
                  f"AUPRC {last[4]:.4f}; best snapshot {best[2]} nnz {best[3]} AUPRC "
                  f"{best[4]:.4f}")
    print(f"[paper] fig1 glm-epsilon: d-GLMNET best AUPRC {fsum['best_dglmnet']:.4f} (path "
          f"{fsum['path_s'] * 1e3:.1f} ms, {fig.PATH_LEN} points) vs TG best "
          f"{fsum['best_tg']:.4f} (sweep {fsum['tg_s'] * 1e3:.1f} ms, "
          f"{len(fig.TG_LAM_DIVS) * len(fig.TG_LRS)} fits x {fig.TG_PASSES} passes, every "
          f"snapshot evaluated); dglmnet_wins {fsum['dglmnet_wins']}; launches {counts}; "
          f"on {card}")
    check(all(pt.ok for pt in fsum["path"]), "a Figure 1 path point is not OK")
    check(fsum["tg_finite"], "a Figure 1 TG snapshot is not finite")
    for lr in fig.TG_LRS:
        lo, hi = (fsum["tg_nnz"][(d, lr, fig.TG_PASSES)] for d in (16, 256))
        check(lo <= hi, f"TG lr {lr}: nnz at lambda_max/16 ({lo}) above lambda_max/256 ({hi})")
    n_fits = len(fig.TG_LAM_DIVS) * len(fig.TG_LRS)
    check(counts["tg_pass"] == n_fits * fig.TG_PASSES,
          f"the TG sweep launched tg_pass {counts['tg_pass']} times")
    check(counts["logistic_stats"] > 0 and counts["gram_cd"] > 0,
          f"the d-GLMNET path launched {counts}")

    ops.reset_launch_counts()
    t_abl = time.perf_counter()
    cells = ablation_parallel_cd.run("twin", "cuda", warmup=False)
    torch.cuda.synchronize()
    t_abl = time.perf_counter() - t_abl
    counts = ops.launch_counts()
    launches.update(counts)
    print(f"[paper] ablation (n, p) = {ablation_parallel_cd.SHAPES['twin']}: {len(cells)} fits "
          f"in {t_abl:.1f} s, launches {counts}, on {card}")
    check(len(cells) == 36 and all(math.isfinite(c["f"]) for c in cells),
          "an ablation fit ended with a non-finite objective")
    check(counts["blocked_cd"] > 0, "the ablation's blocked fits never launched blocked_cd")

    probe = probe_phase(torch, card, lm_inputs)
    launches.update({"flash_attention": probe["flash"]})
    launches.update(probe.pop("path_launches"))
    wall = time.perf_counter() - t_phase
    print(f"[paper] phase wall {wall:.1f} s; on {card}")
    return dict(launches), {"table3": t3, "fig1": fsum, "ablation": cells,
                                 "probe": probe, "wall_s": wall}


def lm_time_rows(torch):
    """Row 6 of the kernel table: the kernel, its plain version and
    scaled_dot_product_attention at the cell's attention shape (bfloat16,
    causal, 32 query heads on 4 KV heads)."""
    return [flash_time_row(torch, LM_BATCH, LM_PROMPT, 32, 4, 64)]


def flash_time_row(torch, B, S, H, Hk, D):
    """flash_attention's timing row at (B, S, H, Hk, D), bfloat16 causal."""
    from repro_torch.kernels import ref
    flash_attention = import_module("repro_torch.kernels.flash_attention")

    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = (torch.randn(B, S, h, D, generator=gen, device="cuda").to(torch.bfloat16)
               for h in (H, Hk, Hk))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_bytes = 2 * (2 * B * S * H * D + 2 * B * S * Hk * D)
    n_flops = 4 * S * S * D * B * H // 2
    return ("flash_attention", "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:84",
            lambda: flash_attention.flash_attention_kernel(q, k, v, causal=True),
            lambda: ref.flash_attention_ref(q, k, v, causal=True),
            lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
            n_bytes, n_flops,
            f"B={B} S={S} H={H} Hk={Hk} D={D} bf16 causal; bound at the bf16 tensor-core "
            f"peak (the f32 CUDA-core peak would give "
            f"{n_flops / F32_FLOPS_PER_S * 1e3:.3f} ms)", BF16_FLOPS_PER_S)


def tg_time_row(torch, ds, flush, launches, card):
    """The kernel table's tg_pass row: one truncated-gradient pass over the
    epsilon cell (16 machines x 20,000 steps x p = 2000), the main path's
    shape, the kernel against its plain version (a host loop of some 55
    launches per step, 11-17 s a call, so timed over one call with no
    warm-up). The timed calls' outputs are kept: every launch bit-equal to
    the first and to the plain version (the row's error is 0). Bound: X
    read once, printed beside the chain bound, 20,000 dependent steps of
    TG_LEAST_NS_PER_STEP each, and this design's chain (steps of
    TG_CHAIN_NS_PER_STEP)."""
    from repro_torch.core.truncated_gradient import shrink as tg_shrink
    from repro_torch.kernels import ref, tg_pass

    M = 16
    n, p = ds.X_train.shape
    S = n // M
    Xs = ds.X_train[:M * S].view(M, S, p)
    ys = ds.y_train[:M * S].view(M, S)
    beta0 = torch.zeros(p, device="cuda")
    shrink = tg_shrink(0.1, 1e-3)
    outs, plain_out = [], []
    ms = time_ms(torch, lambda: outs.append(
        tg_pass.tg_pass_kernel(Xs, ys, beta0, 0.1, shrink, math.inf)), flush)
    plain_ms = time_ms(torch, lambda: plain_out.append(
        ref.tg_pass_ref(Xs, ys, beta0, 0.1, shrink, math.inf)), flush, reps=1, warmup=0)
    got, plain = outs[0], plain_out[0]
    err = max_err(got, plain)
    ok = torch.allclose(got, plain, atol=TOL, rtol=TOL)
    bits = torch.equal(got, plain)
    same = all(torch.equal(got, o) for o in outs[1:])
    print(f"[times] tg_pass M={M} steps={S} p={p}: max abs err {err:.3g} against its plain "
          f"version (atol = rtol = {TOL}; bit-equal {bits}), {len(outs)} "
          f"launches {'bit-equal' if same else 'DIFFERENT'} -> "
          f"{'ok' if ok and bits and same else 'MISMATCH'}")
    check(ok, f"tg_pass at the cell's shape disagrees with its plain version by {err}")
    check(bits, "tg_pass at the cell's shape is not bit-equal to its plain version")
    check(same, "tg_pass at the cell's shape: the timed launches differ")
    del outs, plain_out
    n_bytes = 4 * (M * S * p + M * S + p + M * p)
    n_flops = M * S * (8 * p + 20)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    least_ms = S * TG_LEAST_NS_PER_STEP * 1e-6
    chain_ms = S * TG_CHAIN_NS_PER_STEP * 1e-6
    print(f"[times] tg_pass: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, bound "
          f"{b_ms:.5f} ms ({b_by}: {n_bytes} bytes, {n_flops} operations), chain bound "
          f"{least_ms:.4f} ms ({S} steps x {TG_LEAST_NS_PER_STEP} ns, the least step), this "
          f"design's chain {chain_ms:.4f} ms ({TG_CHAIN_NS_PER_STEP} ns a step) on {card}; "
          f"M={M} steps={S} p={p}, {ms * 1e6 / S:.1f} ns per dependent step, "
          f"{ms / least_ms:.2f}x the chain bound, {ms / chain_ms:.2f}x this design's chain, "
          f"{ms / b_ms:.1f}x the byte bound")
    return {"name": "tg_pass", "route": "cuda", "source": "src/repro_torch/kernels/csrc/tg_pass.cu",
            "replaces": "src/repro/core/truncated_gradient.py:33",
            "launches": launches.get("tg_pass", 0), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def profile_prefill(torch, lm_inputs, card, label: str = "lm"):
    """Device time by kernel over one prefill of a serving cell (with its
    splice into the full cache), then over 8 decode steps after it."""
    from repro_torch.launch.serve import decode, greedy, prefill

    cfg, params, prompts = lm_inputs
    (logits, cache), rows, busy, wall_ms = device_profile(
        torch, f"{label} prefill", lambda: prefill(params, cfg, prompts, LM_PROMPT + LM_TOKENS))
    report_profile(f"{label} prefill", f"{LM_BATCH} x {LM_PROMPT} tokens", rows, busy, wall_ms,
                   card)
    tok = greedy(logits)
    del logits
    decode(params, cfg, cache, LM_PROMPT, tok, 2)       # warm-up
    _, rows, busy, wall_ms = device_profile(
        torch, f"{label} decode", lambda: decode(params, cfg, cache, LM_PROMPT, tok, 8))
    report_profile(f"{label} decode", "8 steps at batch 8", rows, busy, wall_ms, card)


def sparse_time_rows(torch, inp):
    """Rows 4 and 5 of the kernel table: the kernel, its plain version and
    one PyTorch library call on the inputs of one tile step of the cell.
    ``slab_gram``'s kernel and plain version include the gathers of w and
    r; the library call (a CSR x CSR product) starts from gathered
    operands, so its time leaves them out."""
    from repro_torch.kernels import ops, ref
    slab_gram = import_module("repro_torch.kernels.slab_gram")
    slab_spmv = import_module("repro_torch.kernels.slab_spmv")

    R, V, d, r, order, n = inp["R"], inp["V"], inp["d"], inp["r"], inp["order"], inp["n"]
    w = inp["w"]
    safe, va, wv, cva = ops._sentinel_zeroed(R, V, w, r, n)
    B, T, K = R.shape
    live = safe < n
    # block-diagonal CSR forms of the M tiles: (diag(w) X_F)^T and X_F
    bi = torch.arange(B, device="cuda")[:, None, None].expand(B, T, K)[live]
    ex = bi * n + safe[live].long()
    ft = bi * T + torch.arange(T, device="cuda")[None, :, None].expand(B, T, K)[live]
    wX_T = torch.sparse_coo_tensor(torch.stack([ft, ex]), wv[live], (B * T, B * n)
                                   ).coalesce().to_sparse_csr()
    X_csr = torch.sparse_coo_tensor(torch.stack([ex, ft]), va[live], (B * n, B * T)
                                    ).coalesce().to_sparse_csr()
    d_flat = d.reshape(-1).contiguous()
    # matched slot pairs (the join's useful products) and touched rows
    per_row = torch.bincount(ex, minlength=B * n)
    pairs = int((per_row.double() ** 2).sum())
    touched = int((per_row > 0).sum())
    n_live = int(live.sum())
    del safe, va, wv, cva, live, bi, ex, ft, per_row
    r_work = r.clone()
    db_work = torch.zeros(B, 3 * T, device="cuda")[:, T:2 * T]
    dv = torch.where(R < n, V, 0.0) * d[..., None]
    # slab_gram reads rows, values and the tile's order (rows_s, perm) once
    # per slot, w and r once per live slot, and writes G and c; slab_spmv,
    # as the tile step calls it, reads the order's three streams once per
    # slot and d, updates r at the touched rows and dbeta
    gram_bytes = 4 * 4 * B * T * K + 8 * n_live + 4 * (B * T * T + B * T)
    spmv_bytes = 3 * 4 * B * T * K + 4 * B * T + 8 * touched + 8 * B * T

    def gram_plain():
        safe, va, wv, cva = ops._sentinel_zeroed(R, V, w, r, n)
        return ref.slab_gram_join(safe, wv, va, cva)

    return [
        ("slab_gram", "cuda", "src/repro_torch/kernels/csrc/slab_gram.cu",
         "src/repro/kernels/sparse_slab.py:81",
         lambda: slab_gram.slab_gram_kernel(R, V, w, r, rows_sorted=True, order=order),
         gram_plain,
         lambda: torch.sparse.mm(wX_T, X_csr),
         gram_bytes, 2 * pairs + B * T * K + 3 * n_live,
         f"match join T^2 K^2 M = {T * T * K * K * B:.3g} compare-FMA; "
         f"{pairs} matched slot pairs; M={B} T={T} K={K}, {n_live} live slots; kernel and "
         f"plain include the gathers of w and r, the library call does not"),
        ("slab_spmv", "cuda", "src/repro_torch/kernels/csrc/slab_spmv.cu",
         "src/repro/kernels/sparse_slab.py:126",
         lambda: slab_spmv.slab_spmv_kernel(order, V, d, r_work, n_loc=n, sign=-1.0,
                                            dbeta=db_work),
         lambda: (r - ref.slab_spmv_scatter(R.clamp_max(n), dv, n), db_work + d),
         lambda: torch.mv(X_csr, d_flat),
         spmv_bytes, 2 * n_live,
         f"r -= X_F d and dbeta += d (one launch, as the tile step calls it) for M={B} "
         f"blocks of T={T}, K={K}: {n_live} live slots, {touched} rows touched; the "
         f"library call computes X_F d alone"),
    ]


def path_spmv_bytes(torch, inp):
    """Bytes the path mode must move at ``inp``: the order's three streams
    once per slot, per live slot its request's lambda index and its
    coefficient, and one read and write per touched score."""
    rows_s, n_loc = inp["order"].rows_s, inp["n_loc"]
    live = int((rows_s < n_loc).sum())
    touched = sum(int(torch.unique(r[r < n_loc]).numel())
                  for r in rows_s.reshape(-1, rows_s.shape[-1]))
    return 12 * rows_s.numel() + 8 * live + 8 * touched, 2 * live


def serve_time_rows(torch, inputs):
    """Row 5b of the kernel table: ``slab_spmv``'s path mode at the local
    serve shape (one batch row of 2^20 x 8 slots), its plain version; no
    single PyTorch call gathers a per-row coefficient."""
    from repro_torch.kernels import ref
    slab_spmv = import_module("repro_torch.kernels.slab_spmv")

    inp = inputs[0]
    out = torch.zeros(inp["rows"].shape[0], inp["n_loc"], device="cuda")
    n_bytes, n_flops = path_spmv_bytes(torch, inp)
    return [("slab_path_spmv", "cuda", "src/repro_torch/kernels/csrc/slab_spmv.cu",
             "src/repro/kernels/sparse_slab.py:126",
             lambda: slab_spmv.slab_path_spmv_kernel(inp["order"], inp["vals"], inp["lam_idx"],
                                                     inp["betas"], out, n_loc=inp["n_loc"]),
             lambda: ref.slab_path_spmv_scatter(inp["rows"], inp["vals"], inp["lam_idx"],
                                                inp["betas"], inp["n_loc"]),
             None, n_bytes, n_flops,
             f"path mode (ops.slab_path_spmv, src/repro/kernels/ops.py:189) at the local serve "
             f"shape {tuple(inp['rows'].shape)}, L={inp['betas'].shape[0]}, "
             f"{n_flops // 2} live slots")]


def serve_extra_times(torch, inputs, flush, card):
    """The path mode at the mesh store's shape, beside its byte bound."""
    slab_spmv = import_module("repro_torch.kernels.slab_spmv")

    inp = inputs[1]
    out = torch.zeros(inp["rows"].shape[0], inp["n_loc"], device="cuda")
    ms = time_ms(torch, lambda: slab_spmv.slab_path_spmv_kernel(
        inp["order"], inp["vals"], inp["lam_idx"], inp["betas"], out, n_loc=inp["n_loc"]), flush)
    n_bytes, n_flops = path_spmv_bytes(torch, inp)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    print(f"[times] slab_path_spmv at the mesh serve shape {tuple(inp['rows'].shape)}: kernel "
          f"{ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: {n_bytes} bytes) on {card}")


def spmv_extra_times(torch, inp, flush, card):
    """slab_spmv without its fused dbeta update at the tile step, and at
    the margins' shape (16 blocks of p/16 features into zeroed margins),
    each beside its byte bound."""
    slab_spmv = import_module("repro_torch.kernels.slab_spmv")
    from repro_torch.kernels.slab_spmv import slab_order

    R, V, d, r, order, n = inp["R"], inp["V"], inp["d"], inp["r"], inp["order"], inp["n"]
    B, T, K = R.shape
    r_work = r.clone()
    ms = time_ms(torch, lambda: slab_spmv.slab_spmv_kernel(order, V, d, r_work, n_loc=n,
                                                           sign=-1.0), flush)
    touched = int(sum(torch.unique(order.rows_s[b][order.rows_s[b] < n]).numel()
                      for b in range(B)))
    b_ms, _ = bound_ms(3 * 4 * B * T * K + 4 * B * T + 8 * touched, 0)
    print(f"[times] slab_spmv without dbeta (r -= X_F d alone) M={B} T={T} K={K}: kernel "
          f"{ms:.4f} ms, bound {b_ms:.5f} ms (bytes) on {card}")
    Rm, Vm, beta = inp["margins"]
    om = slab_order(Rm, Vm)
    M, Tm, Km = Vm.shape
    out = torch.zeros(M, n, device="cuda")
    ms = time_ms(torch, lambda: slab_spmv.slab_spmv_kernel(om, Vm, beta, out, n_loc=n,
                                                           sign=1.0), flush, reps=10)
    touched = int(sum(torch.unique(om.rows_s[b][om.rows_s[b] < n]).numel() for b in range(M)))
    n_bytes = 3 * 4 * M * Tm * Km + 4 * M * Tm + 8 * touched
    b_ms, _ = bound_ms(n_bytes, 2 * int((om.rows_s < n).sum()))
    print(f"[times] slab_spmv at the margins' shape M={M} p/M={Tm} K={Km}: kernel {ms:.4f} ms, "
          f"bound {b_ms:.5f} ms (bytes: {n_bytes}; {touched} rows touched) on {card}")


def phase_times(torch, gen, errs, launches, card, sparse_inputs, ds):
    from repro_torch.core.subproblem import blocked_cycle_modes
    from repro_torch.kernels import blocked_cd, ref
    gram_cd = import_module("repro_torch.kernels.gram_cd")
    logistic_stats = import_module("repro_torch.kernels.logistic_stats")

    # 1 GB > L2; zeroing it also gives the host time to queue the timed call
    flush = torch.empty(256 * 2 ** 20, device="cuda")
    rows = []
    n = 320_000
    m = 4.0 * torch.randn(n, generator=gen, device="cuda")
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1.0, -1.0)
    rows.append(("logistic_stats", "cuda", "src/repro_torch/kernels/csrc/logistic_stats.cu",
                 "src/repro/kernels/logistic_stats.py:50",
                 lambda: logistic_stats.logistic_stats_kernel(m, y),
                 lambda: ref.logistic_stats_ref(m, y),
                 16 * n + 4, 30 * n))
    M, F = 16, 128
    G, c, beta, db0, lam = tile_inputs(torch, gen, M, F)
    tile_bytes = 4 * (M * F * F + 4 * M * F)
    rows.append(("gram_cd", "cuda", "src/repro_torch/kernels/csrc/gram_cd.cu",
                 "src/repro/kernels/gram_cd.py:66",
                 lambda: gram_cd.gram_cd_kernel(G, c, beta, db0, lam, 1e-6),
                 lambda: ref.gram_cd_ref(G, c, beta, db0, lam, 1e-6),
                 tile_bytes, 2 * M * F * F + 10 * M * F))
    rows.append(("blocked_cd", "cuda", "src/repro_torch/kernels/csrc/blocked_cd.cu",
                 "src/repro/kernels/blocked_cd.py:132",
                 lambda: blocked_cd.blocked_cd_kernel(G, c, beta, db0, lam, 1e-6, block=16),
                 lambda: ref.blocked_cd_ref(G, c, beta, db0, lam, 1e-6, block=16),
                 tile_bytes, 2 * M * F * F + 10 * M * F))
    rows = ([(*row[:6], None, *row[6:], "") for row in rows] + sparse_time_rows(torch, sparse_inputs)
            + serve_time_rows(torch, sparse_inputs["serve"]))
    rows = [(*row, F32_FLOPS_PER_S) for row in rows] + lm_time_rows(torch)
    table = []
    for row in rows:
        name, route, source, replaces = row[:4]
        ms, plain_ms, library_ms, b_ms, b_by = time_row(torch, row, flush, card)
        if name in ("gram_cd", "blocked_cd"):
            modes = blocked_cycle_modes(G, 16).flatten().tolist()
            print(f"[times] {name}: {ms * 1e6 / F:.1f} ns per coordinate step (kernel time / "
                  f"F, F={F}, M={M}{'' if name == 'gram_cd' else f', B=16, modes {Counter(modes)}'}"
                  f"; one launch, as the path calls it)")
        table.append({"name": name, "route": route, "source": source,
                      "replaces": replaces, "launches": launches.get(name, 0),
                      "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms})
    table.append(tg_time_row(torch, ds, flush, launches, card))
    spmv_extra_times(torch, sparse_inputs, flush, card)
    serve_extra_times(torch, sparse_inputs["serve"], flush, card)
    return table


def time_row(torch, row, flush, card, label=None):
    """Time one row of the kernel table (the kernel, its plain version and
    the library call, CUDA events) and print it beside its bound. Returns
    (ms, plain ms, library ms or None, bound ms, bound kind)."""
    name, _, _, _, kern, plain, library, n_bytes, n_flops, note, peak = row
    ms = time_ms(torch, kern, flush)
    plain_ms = time_ms(torch, plain, flush)
    library_ms = None if library is None else time_ms(torch, library, flush)
    b_ms, b_by = bound_ms(n_bytes, n_flops, peak)
    print(f"[times] {label or name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
          f"{b_ms:.5f} ms ({b_by}: {n_bytes} bytes, {n_flops} operations) on {card}"
          + (f"; {note}" if note else ""))
    return ms, plain_ms, library_ms, b_ms, b_by


def _kind(name: str) -> str:
    low = name.lower()
    if "logistic_stats" in low:
        return "logistic_stats kernel"
    if "gram_cd_kernel" in low or "blocked_cd_kernel" in low:
        return "tile CD kernel"
    if "slab_gram_kernel" in low:
        return "slab_gram kernel"
    if "slab_spmv_kernel" in low:
        return "slab_spmv kernel"
    if "flash_bf16_kernel" in low or "flash_f32_kernel" in low:
        return "flash_attention kernel"
    if "tg_pass_kernel" in low:
        return "tg_pass kernel"
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "cublas", "dot_kernel",
                              "nvjet")):
        return "matmul (cuBLAS)"
    if "sort" in low:
        return "sorts (slab layout, MoE routing)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other elementwise and reductions (line search, gathers, norms, RoPE, casts)"


def device_profile(torch, label: str, fn):
    """Run ``fn()`` under torch.profiler; returns (its result, the device
    time rows (ms, count, name) by kernel, busy ms, wall ms). A profile
    with no device time fails the run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and getattr(ev.device_type, "name", "") == "CUDA":
            rows.append((us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    check(bool(rows), f"profile {label}: the profiler recorded no device time")
    return res, rows, sum(r[0] for r in rows), wall_ms


def report_profile(label: str, what: str, rows, busy, wall_ms, card):
    """Print a profile's busy and idle time, its shares by kind and each
    hand-written kernel's time per launch."""
    groups = Counter()
    for ms, _, name in rows:
        groups[_kind(name)] += ms
    print(f"[profile] {label}: {what}, wall {wall_ms:.1f} ms under the "
          f"profiler, device busy {busy:.1f} ms (idle share {1 - busy / wall_ms:.2f}) "
          f"on {card}")
    for kind, ms in groups.most_common():
        print(f"[profile] {label}:   {kind}: {ms:.2f} ms ({ms / busy:.1%} of busy)")
    for ms, count, name in rows[:10]:
        print(f"[profile] {label}:     {ms:8.2f} ms {count:6d}x {name[:90]}")
    for ms, count, name in rows:
        if _kind(name).endswith(" kernel"):
            print(f"[profile] {label}: {name[:40]}: {ms / count * 1e3:.1f} us per "
                  f"launch in the run ({count} launches)")


def profile_fit(torch, label: str, fit, card):
    """Device time by kernel over one fit (torch.profiler); returns the
    fit's result and the profile's rows."""
    res, rows, busy, wall_ms = device_profile(torch, label, fit)
    report_profile(label, f"{res.n_iters} iters", rows, busy, wall_ms, card)
    return res, rows


def phase_profile(torch, ds, lam, cell, sparse_lam, card, lm_inputs):
    """One dense fit and a 3-iteration sparse fit per cycle mode, a 2-pass
    truncated-gradient fit, the path's head and one LM prefill, profiled."""
    from repro_torch.api import DenseDesign, LogisticL1, SlabDesign
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.launch.mesh import make_dev_mesh

    from repro_torch.core.truncated_gradient import TGOptions, truncated_gradient_fit

    for mode in ("sequential", "blocked"):
        est = LogisticL1(DGLMNETOptions(num_blocks=16, tile=128, max_iters=100,
                                        cycle_mode=mode, block=16), device="cuda")
        profile_fit(torch, f"dense {mode}",
                    lambda: est.fit(DenseDesign(ds.X_train), ds.y_train, lam), card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, tg_rows, busy, wall_ms = device_profile(torch, "tg fit", lambda: truncated_gradient_fit(
        ds.X_train, ds.y_train, lam, opts=TGOptions(num_machines=16, passes=2), generator=gen,
        device="cuda"))
    report_profile("tg fit", "2 shuffled passes of 16 machines over the dense cell", tg_rows,
                   busy, wall_ms, card)
    (rows, vals, y), _ = cell
    for mode in ("sequential", "blocked"):
        opts = DGLMNETOptions(**dict(SPARSE_OPTS, max_iters=3, cycle_mode=mode))
        est = LogisticL1(opts, mesh=make_dev_mesh(1, SPARSE_M), device="cuda")
        label = f"sparse {mode} (3 iterations)"
        res, prof = profile_fit(torch, label, lambda: est.fit(
            SlabDesign(rows, vals, y.shape[0]), y, sparse_lam), card)
        # device launches per tile step: all of the fit's, layout and
        # per-iteration work included, over its iterations x tile steps
        steps = res.n_iters * (rows.shape[0] // (SPARSE_M * opts.tile))
        total = sum(count for _, count, _ in prof)
        print(f"[profile] {label}: {total} device launches over {steps} tile steps: "
              f"{total / steps:.2f} per tile step")
        print(f"[sparse] {mode}: {total / steps:.2f} device launches per tile step "
              f"(torch.profiler, {res.n_iters} iterations, layout included)")
        for _, count, name in sorted(prof, key=lambda row: -row[1]):
            if count >= steps:
                print(f"[profile] {label}:   {count / steps:.2f} per tile step: {name[:90]}")
    del rows, vals, y
    profile_path(torch, cell, card)
    profile_prefill(torch, lm_inputs, card)


#: the path's device-bound stages timed apart in its profile: (label,
#: owner, attribute)
PATH_STAGES = (("screen passes", "ShardedDesign", "_screen_abs_work"),
               ("gathers", "ShardedDesign", "_gather_work"),
               ("layout sorts", "estimator", "layout_slabs"))


#: points of the profiled path (lambda_max/2, /4): its third point, about a
#: third of the tile steps, was cut for the script's time (its profile took
#: 86-105 s of reading on the host)
PROFILE_PATH_LEN = 2


def profile_path(torch, cell, card):
    """The path's first ``PROFILE_PATH_LEN`` points (reading a profile
    takes the host about 6 s per thousand tile steps) in the
    sequential cycle mode under torch.profiler (the blocked mode's profile,
    about 85 s of reading, was cut to make room for the paper phase): busy
    and idle time and the device time by kernel. Its
    device-bound stages (screen passes, working-set gathers, the layout
    sorts of each restricted solve) are bracketed by a synchronise and
    CUDA events, so each one's device time is read apart (an upper bound
    of its busy time); the rest of the busy time is the restricted
    solves' tile steps and line searches and the driver's elementwise
    work."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import LogisticL1, ShardedDesign, SlabDesign, estimator
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.launch.mesh import make_dev_mesh

    owners = {"estimator": estimator, "ShardedDesign": ShardedDesign}
    saved = [(owners[o], a, getattr(owners[o], a)) for _, o, a in PATH_STAGES]
    spans = []

    def timed(label, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.append((label, start, end))
            return out
        return run

    (rows, vals, y), _ = cell
    design = SlabDesign(rows, vals, y.shape[0])
    try:
        for (label, _, _), (owner, attr, fn) in zip(PATH_STAGES, saved):
            setattr(owner, attr, timed(label, fn))
        est = LogisticL1(DGLMNETOptions(cycle_mode="sequential", **SPARSE_OPTS),
                         mesh=make_dev_mesh(1, SPARSE_M), device="cuda")
        spans.clear()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = est.path(design, y, path_len=PROFILE_PATH_LEN)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        rows_ = []
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            if us > 0 and getattr(ev.device_type, "name", "") == "CUDA":
                rows_.append((us / 1e3, ev.count, ev.key))
        rows_.sort(reverse=True)
        label = f"path sequential (lambda_max/2 ... /{2 ** PROFILE_PATH_LEN})"
        check(bool(rows_), f"profile {label}: the profiler recorded no device time")
        busy = sum(r[0] for r in rows_)
        report_profile(label, f"{len(res)} points", rows_, busy, wall_ms, card)
        stage_ms = Counter()
        for name, start, end in spans:
            stage_ms[name] += start.elapsed_time(end)
        for name, _, _ in PATH_STAGES:
            print(f"[profile] {label}: {name}: {stage_ms[name]:.2f} ms of device time "
                  f"({stage_ms[name] / busy:.1%} of busy), "
                  f"{sum(1 for s in spans if s[0] == name)} calls")
        rest = busy - stage_ms["screen passes"] - stage_ms["gathers"]
        print(f"[profile] {label}: restricted solves and the driver's elementwise work: "
              f"{rest:.2f} ms ({rest / busy:.1%} of busy; the layout sorts within it); "
              f"reading the profile took {time.perf_counter() - t1:.1f} s on the host")
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def phase_sparse_host(torch, card, repeats: int = 2):
    """``--sparse-host``: the sparse cell alone, for an A/B of two
    checkouts run in turns (``--src`` names the other checkout's ``src``).
    It calls only interfaces that the port has kept since the slab solve
    came in, so one copy of it drives either side. Per cycle mode, in
    turns, ``repeats`` fits, each with its wall and the host thread's CPU
    time per tile step; five times as many runs of one outer iteration's
    tile loop (``local_subproblem_sparse``) alone; the host time of the
    tile step's residual update as the checkout makes it; then
    ``slab_spmv`` at the margins' shape: the kernel on a built order, and
    ``ops.slab_spmv`` with ``order=None`` end to end (the order built in
    the call)."""
    import inspect

    from repro_torch.api import LogisticL1, SlabDesign, lambda_max_design
    from repro_torch.core.dglmnet import DGLMNETOptions
    from repro_torch.core.distributed import layout_slabs, local_subproblem_sparse
    from repro_torch.core.subproblem import NU
    from repro_torch.kernels import ops
    slab_spmv = import_module("repro_torch.kernels.slab_spmv")
    from repro_torch.launch.mesh import make_dev_mesh

    t0 = time.perf_counter()
    cell = sparse_cell(torch)
    torch.cuda.synchronize()
    print(f"[sparse-host] cell generated on the card in {time.perf_counter() - t0:.2f} s; "
          f"package {Path(ops.__file__).resolve().parents[2]}")
    (rows, vals, y), _ = cell
    n, p, K = y.shape[0], rows.shape[0], rows.shape[-1]
    M, T = SPARSE_M, SPARSE_OPTS["tile"]
    steps = p // (M * T)
    design = SlabDesign(rows, vals, n)
    lam = float(lambda_max_design(design, y)) / 16
    mesh = make_dev_mesh(1, M)
    modes = ("sequential", "blocked")
    for mode in modes:                  # warm-up: allocator pools
        LogisticL1(DGLMNETOptions(**dict(SPARSE_OPTS, max_iters=1, cycle_mode=mode)),
                   mesh=mesh, device="cuda").fit(design, y, lam)
    for rep in range(repeats):
        for mode in modes:
            est = LogisticL1(DGLMNETOptions(cycle_mode=mode, **SPARSE_OPTS), mesh=mesh,
                             device="cuda")
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.thread_time()
            res = est.fit(design, y, lam)
            torch.cuda.synchronize()
            wall, cpu = time.perf_counter() - t0, time.thread_time() - c0
            check(res.ok, f"sparse {mode} fit tripped {res.status_name}")
            per = res.n_iters * steps
            print(f"[sparse-host] {mode} fit {rep + 1}: {res.n_iters} iters, f {res.f:.4f}, "
                  f"{wall * 1e3 / res.n_iters:.2f} ms per outer iteration; per tile step "
                  f"{wall * 1e6 / per:.2f} us wall, {cpu * 1e6 / per:.2f} us host thread CPU, "
                  f"on {card}")
    lay = layout_slabs(rows[:, 0], vals[:, 0], M, T)
    gen = torch.Generator(device="cuda").manual_seed(7)
    w = 0.05 + 0.2 * torch.rand(n, generator=gen, device="cuda")
    z = torch.randn(n, generator=gen, device="cuda")
    beta = torch.zeros(M, steps * T, device="cuda")
    # one outer iteration's tile loop, many times: its minimum is the host
    # cost with the least interference from other work on the host
    loops = {mode: [] for mode in modes}
    for rep in range(5 * repeats):
        for mode in modes:
            r = z.expand(M, -1).clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            local_subproblem_sparse(lay, w, r, beta, lam, tile=T, nu=NU, cycle_mode=mode,
                                    block=SPARSE_OPTS["block"])
            torch.cuda.synchronize()
            loops[mode].append((time.perf_counter() - t0) * 1e3)
    for mode, ms in loops.items():
        print(f"[sparse-host] {mode} tile loop (one outer iteration, {steps} tile steps), "
              f"{len(ms)} runs: min {min(ms):.2f} ms, median {statistics.median(ms):.2f} ms "
              f"({min(ms) * 1e3 / steps:.2f} / {statistics.median(ms) * 1e3 / steps:.2f} us "
              f"per tile step); all {[round(x, 2) for x in ms]}, on {card}")
    # the residual update as this checkout's tile step makes it (one call
    # with dbeta where ops.slab_residual_update takes it, else the call
    # and dbeta[:, sl] += d), timed on the host: batches of 200 enqueued
    # calls, each far longer on the host than on the card
    fused = "dbeta" in inspect.signature(ops.slab_residual_update).parameters
    t = steps // 2
    rows_t, vals_t = lay.rows[:, t], lay.vals[:, t]
    order_t = slab_spmv.SlabOrder(*(f[:, t] for f in lay.order))
    d = 1e-3 * torch.randn(M, T, generator=gen, device="cuda")
    r = z.expand(M, -1).clone()
    db = torch.zeros(M, steps * T, device="cuda")
    sl = slice(t * T, (t + 1) * T)

    def update():
        if fused:
            ops.slab_residual_update(r, rows_t, vals_t, d, order=order_t, dbeta=db[:, sl])
        else:
            ops.slab_residual_update(r, rows_t, vals_t, d, order=order_t)
            db[:, sl] += d

    per = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            update()
        per.append((time.perf_counter() - t0) * 1e6 / 200)
    torch.cuda.synchronize()
    print(f"[sparse-host] residual update as the tile step makes it "
          f"({'one fused call' if fused else 'the call and dbeta += d'}), host time per "
          f"step over {len(per)} batches of 200: min {min(per):.2f} us, median "
          f"{statistics.median(per):.2f} us, on {card}")
    del lay, r
    flush = torch.empty(256 * 2 ** 20, device="cuda")
    Rm, Vm = rows[:, 0].reshape(M, p // M, K), vals[:, 0].reshape(M, p // M, K)
    bm = torch.randn(M, p // M, generator=gen, device="cuda")
    with_vals = len(inspect.signature(slab_spmv.slab_order).parameters) > 1
    om = slab_spmv.slab_order(Rm, Vm) if with_vals else slab_spmv.slab_order(Rm)
    out = torch.zeros(M, n, device="cuda")
    k_ms = time_ms(torch, lambda: slab_spmv.slab_spmv_kernel(om, Vm, bm, out, n_loc=n,
                                                             sign=1.0), flush, reps=10)
    del om, out
    e_ms = time_ms(torch, lambda: ops.slab_spmv(Rm, Vm, bm, n_loc=n), flush, reps=10)
    print(f"[sparse-host] slab_spmv at the margins' shape M={M} p/M={p // M} K={K}: kernel "
          f"on a built order {k_ms:.4f} ms; ops.slab_spmv(order=None) end to end "
          f"{e_ms:.4f} ms (order built per call); on {card}")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sparse-host", action="store_true",
                    help="time only the sparse cell's fits, tile loop and margins product")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the src directory whose repro_torch is driven (--sparse-host)")
    ap.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-work", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        # a rank of phase 9a, spawned by phase_process_mesh
        return mesh_rank_main(args.mesh_work, args.mesh_rank)
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    sys.path.insert(0, str(args.src.resolve() if args.sparse_host else ROOT / "src"))
    import repro_torch  # noqa: F401  (applies the precision policy)

    if args.sparse_host:
        card = phase_device(torch)
        phase_build(torch)
        phase_sparse_host(torch, card)
        return 0

    t_start = time.perf_counter()
    card = phase_device(torch)
    phase_build(torch)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs = phase_kernels(torch, gen)
    launches, fits, ds, lam, main_results = phase_main_path(torch)
    phase_agreement(torch)
    t0 = time.perf_counter()
    cell = sparse_cell(torch)
    torch.cuda.synchronize()
    print(f"[sparse] cell generated on the card in {time.perf_counter() - t0:.2f} s")
    sparse_errs, sparse_inputs = phase_sparse_kernels(torch, gen, cell)
    errs.update(sparse_errs)
    sparse_launches, sparse_fits, sparse_lam = phase_sparse_path(torch, cell, card)
    for name, count in sparse_launches.items():
        launches[name] = launches.get(name, 0) + count
    path_launches, path_walls = phase_path(
        torch, cell, card, {mode: (sparse_lam, *fit[4:6]) for mode, fit in sparse_fits.items()})
    for name, count in path_launches.items():
        launches[name] = launches.get(name, 0) + count
    stream_launches, stream_runs = phase_streamed_path(torch, cell, card)
    for name, count in stream_launches.items():
        launches[name] = launches.get(name, 0) + count
    seq_path = path_walls["sequential"].pop("result")
    path_head = list(seq_path.f[:PM_PATH_LEN])
    eps_f = main_results["sequential"].f
    launches["slab_path_spmv"], serve_stats = phase_serve(torch, card, seq_path)
    path_walls["blocked"].pop("result")
    chaos_launches, chaos = phase_chaos(torch, card, ds, lam, main_results, cell, seq_path,
                                        path_walls["sequential"], stream_runs)
    for name, count in chaos_launches.items():
        launches[name] = launches.get(name, 0) + count
    del seq_path, main_results
    for r in stream_runs.values():
        r.pop("host_buckets")
    phase_sparse_agreement(torch)
    phase_path_agreement(torch)
    fit7 = sparse_fits["sequential"]
    from repro_torch.configs.glm import GLM_EPSILON

    mesh_launches = phase_process_mesh(torch, card, cell, (fit7[1], *fit7[4:]), sparse_lam,
                                       GLM_EPSILON.num_examples, lam, eps_f, path_head)
    for name, count in mesh_launches.items():
        launches[name] = launches.get(name, 0) + count
    errs.update(phase_lm_kernels(torch, gen))
    lm_launches, lm_stats, lm_inputs = phase_lm(torch, card)
    launches.update(lm_launches)
    phase_lm_agree(torch)
    paper_launches, paper = phase_paper(torch, card, ds, lm_inputs)
    for name, count in paper_launches.items():
        launches[name] = launches.get(name, 0) + count
    lm_train = phase_lm_train(torch, card)
    phase_lm_train_agree(torch)
    table = phase_times(torch, gen, errs, launches, card, sparse_inputs, ds)
    del sparse_inputs
    for mode, (wall, wall2, iters, syncs) in fits.items():
        print(f"[times] fit {mode}: {wall:.3f} s whole fit (again {wall2:.3f} s), "
              f"{wall * 1e3 / iters:.2f} ms per outer iteration ({iters} iterations), "
              f"{syncs} host syncs, on {card}")
    for mode, (wall, iters, syncs, peak, *_) in sparse_fits.items():
        print(f"[times] sparse fit {mode}: {wall:.3f} s whole fit, "
              f"{wall * 1e3 / iters:.2f} ms per outer iteration ({iters} iterations), "
              f"{syncs} host syncs, {peak:.2f} GB peak, on {card}")
    for mode, w in path_walls.items():
        print(f"[times] path {mode} ({PATH_LEN} points): {w['wall_ms']:.1f} ms, down to "
              f"lambda_max/16 {w['to16_ms']:.1f} ms, {w['solves']} restricted solves of "
              f"{w['iters']} iterations in all, {w['syncs']} host syncs, {w['peak']:.2f} GB "
              f"peak, one screen pass {w['screen_ms']:.3f} ms, on {card}")
    for label, r in stream_runs.items():
        print(f"[times] streamed-path cell, {label} ({STREAM_PATH_LEN} points): "
              f"{r['wall_ms']:.1f} ms, one screen pass {r['screen_ms']:.3f} ms moving "
              f"{r['pass_bytes']} bytes, peak {r['peak'] / 1e9:.3f} GB, on {card}")
    for label, r in serve_stats.items():
        if isinstance(r, dict):
            print(f"[times] serve {label}: {r['rate']:,.1f} scores/s, {r['ms']:.2f} ms per "
                  f"batch (pack {r['pack_ms']:.2f}, copy {r['copy_ms']:.3f}, order "
                  f"{r['order_ms']:.3f}, kernel {r['kernel_ms']:.4f} ms), peak "
                  f"{r['peak'] / 1e9:.3f} GB, on {card}")
    print(f"[times] serve checkpoint: save {serve_stats['save_ms']:.1f} ms, load "
          f"{serve_stats['load_ms']:.1f} ms, on {card}")
    k, lb = chaos["kill"], chaos["lost"]
    print(f"[times] chaos: path killed after {CHAOS_KILL_AT} points {k['killed_ms']:.1f} ms, "
          f"resumed {k['debug_ms'] + k['resumed_ms']:.1f} ms (uninterrupted "
          f"{path_walls['sequential']['wall_ms']:.1f} ms), checkpoint per point median "
          f"{statistics.median(ms for _, ms in k['saves']):.1f} ms; transient lost bucket "
          f"{lb['transient_ms']:.1f} ms against {lb['streamed_ms']:.1f} ms streamed; phase "
          f"{chaos['wall_s']:.1f} s; on {card}")
    t3, f1 = paper["table3"], paper["fig1"]
    print(f"[times] paper glm-epsilon: table3 d-GLMNET {t3['iters']} iterations, "
          f"{t3['iter_ms']:.3f} ms per iteration, line-search share {t3['ls_share']:.3f}, TG "
          f"{t3['tg_pass_ms']:.3f} ms per pass; fig1 best AUPRC d-GLMNET "
          f"{f1['best_dglmnet']:.4f} vs TG {f1['best_tg']:.4f} (dglmnet_wins "
          f"{f1['dglmnet_wins']}); probe best AUPRC {paper['probe']['best_auprc']:.4f}; "
          f"phase {paper['wall_s']:.1f} s; on {card}")
    print(f"[times] lm serve {LM_ARCH}: prefill {lm_stats['prefill_ms']:.2f} ms, decode "
          f"{lm_stats['decode_ms_per_token']:.3f} ms/token, whole generation "
          f"{lm_stats['wall_s']:.3f} s, {lm_stats['peak_gb']:.2f} GB peak, on {card}")
    print(f"[times] lm train {LM_ARCH}: {lm_train['ms']:.2f} ms per step of "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, {lm_train['tokens_s']:.0f} tokens/s, "
          f"bound share {lm_train['bound_ms'] / lm_train['ms']:.4f}, loss "
          f"{lm_train['loss0']:.4f} -> {lm_train['loss_last']:.4f}, {lm_train['peak_gb']:.2f} GB "
          f"peak, on {card}")
    phase_profile(torch, ds, lam, cell, sparse_lam, card, lm_inputs)
    del lm_inputs                     # the LM zoo cells need the room
    moe_launches, moe = phase_lm_moe(torch, card)
    _, ssm = phase_lm_ssm(torch, card)
    flush = torch.empty(256 * 2 ** 20, device="cuda")
    dense = phase_lm_dense(torch, card, flush)
    del flush
    torch.cuda.empty_cache()
    _, mla = phase_lm_mla(torch, card)
    # row 6 keeps the tinyllama path's launches; rows 6b-6e carry their cells' own
    # (the SSM and MLA cells launch none: zoo_cell holds them to 0)
    row6 = next(row for row in table if row["name"] == "flash_attention")
    row6.update(cell=LM_ARCH, row="6")
    cells = [("6b", MOE_ARCH, "moe cell", MOE_FLASH_SHAPE, moe_launches, moe["row6b"])]
    cells += [(f"6{r}", arch, f"{arch} cell", DENSE_FLASH_SHAPES[arch], dense[arch][0],
               dense[arch][2]) for r, arch in zip("cde", DENSE_ARCHS)]
    for row_id, arch, label, (B, S, H, Hk, D), n, timing in cells:
        ms, plain_ms, library_ms, b_ms, b_by = timing
        table.append(dict(row6, launches=n, max_abs_err=errs[f"flash_attention ({label})"],
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=library_ms, cell=arch, row=row_id,
                          shape=f"B={B} S={S} H={H} Hk={Hk} D={D} bf16 causal"))
    for tag, arch, r in ([("moe", f"{MOE_ARCH} ({MOE_LAYERS} layers)", moe),
                          ("ssm", SSM_ARCH, ssm)]
                         + [("dense", arch, dense[arch][1]) for arch in DENSE_ARCHS]
                         + [("mla", f"{MLA_ARCH} ({MLA_LAYERS} layers, no MTP head)", mla)]):
        print(f"[times] lm {tag} serve {arch}: prefill {r['prefill_ms']:.2f} ms, decode "
              f"{r['decode_ms_per_token']:.3f} ms/token, whole generation {r['wall_s']:.3f} s, "
              f"{r['peak_gb']:.2f} GB peak, phase {r['phase_s']:.1f} s, on {card}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
