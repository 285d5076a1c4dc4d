#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each
of which fails the run with a non-zero exit:

1. device -- a CUDA card must be present (no CPU fallback); prints its
   name and power limit and the torch/CUDA versions;
2. build -- compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, in parallel) and the Triton kernel;
3. kernels -- each kernel against its plain PyTorch version on the card at
   the main path's shapes (atol = rtol = 1e-5; the NLL to 1e-5 relative),
   ``blocked_cd`` on a tile where modes 0, 1 and 2 all occur, and
   ``blocked_cd`` at B=1 bit-equal to ``gram_cd``;
4. main path -- ``LogisticL1(...).fit(DenseDesign(X), y, lam)`` at the
   paper's epsilon scale (320,000 x 2000 training rows, generated on the
   card), M=16 blocks of one 128-wide tile, lam = lambda_max / 16, in both
   cycle modes: status OK, objective history non-increasing (within the
   snap-back tolerance), every kernel of the path launched; launch counts
   are zeroed just before each fit and read just after;
5. agreement -- a reduced fit (8192 x 2000) on the card against the same
   fit on the CPU (plain versions): relative objective gap < 1e-4, betas
   within rtol 1e-2 / atol 1e-3; the card fit's synchronising calls, as
   torch's sync debug mode sees them, must equal the engine's count;
6. times -- each kernel and its plain version (CUDA events, median of 25
   launches after warm-up, L2 flushed before each), beside its bound.

Prints the kernel table as one JSON line, then the card's name and power
limit, then a last JSON line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
# H100 SXM data-sheet peaks used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


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


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def tile_inputs(torch, gen, M: int, F: int, n: int = 4096, kind: str = "random"):
    """Gram tiles G = Xf^T diag(w) Xf and c = (w Xf)^T r as the main path
    builds them. ``kind="modes"`` makes each 16-wide block of features
    independent, pairwise-correlated across halves, or duplicated, so the
    blocked cycle's modes 0, 1 and 2 all occur."""
    dev = "cuda"
    Xf = torch.randn(M, n, F, generator=gen, device=dev)
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
    from repro_torch.kernels import build, ops

    t0 = time.perf_counter()
    secs = build.build_all()
    t_nvcc = time.perf_counter() - t0
    for name, log in build.ptxas_log.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: " + " | ".join(lines))
    # the Triton kernel compiles at its first launch
    m = torch.zeros(8, device="cuda")
    t1 = time.perf_counter()
    ops.logistic_stats(m, torch.ones_like(m))
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t1
    print(f"[build] nvcc (parallel) {t_nvcc:.2f} s "
          f"{ {k: round(v, 2) for k, v in secs.items()} }; "
          f"triton logistic_stats {t_triton:.2f} s")


def phase_kernels(torch, gen):
    from repro_torch.core.subproblem import blocked_cycle_modes
    from repro_torch.kernels import blocked_cd, gram_cd, logistic_stats, ref

    errs = {}
    # logistic_stats: main-path n, a ragged n, and extreme margins
    for label, n, scale in (("n=320000", 320_000, 4.0), ("ragged n=100003", 100_003, 4.0),
                            ("margins +-40/+-100", 4099, 0.0)):
        if scale:
            m = scale * torch.randn(n, generator=gen, device="cuda")
        else:
            m = torch.tensor([40.0, -40.0, 100.0, -100.0, 88.0, -88.0, 0.0],
                             device="cuda").repeat(-(-n // 7))[:n].contiguous()
        y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1.0, -1.0)
        w, z, nll = logistic_stats.logistic_stats_kernel(m, y)
        w0, z0, nll0 = ref.logistic_stats_ref(m, y)
        torch.cuda.synchronize()
        ok = (torch.allclose(w, w0, rtol=TOL, atol=TOL)
              and torch.allclose(z, z0, rtol=TOL, atol=TOL)
              and abs(float(nll) - float(nll0)) <= TOL * abs(float(nll0)))
        e = max(max_err(w, w0), max_err(z, z0))
        print(f"[kernels] logistic_stats {label}: max|dw|,|dz| {e:.3g}, "
              f"nll {float(nll):.6f} vs {float(nll0):.6f} -> {'ok' if ok else 'MISMATCH'}")
        check(ok, f"logistic_stats {label} disagrees with its plain version")
        errs.setdefault("logistic_stats", e)

    for M, F in ((16, 128), (1, 256), (16, 64)):
        G, c, beta, db0, lam = tile_inputs(torch, gen, M, F)
        d = gram_cd.gram_cd_kernel(G, c, beta, db0, lam, 1e-6)
        d0 = ref.gram_cd_ref(G, c, beta, db0, lam, 1e-6)
        torch.cuda.synchronize()
        e = max_err(d, d0)
        ok = torch.allclose(d, d0, rtol=TOL, atol=TOL)
        print(f"[kernels] gram_cd M={M} F={F}: max|dd| {e:.3g}, "
              f"nnz {int((d0 + beta + db0 != 0).sum())}/{M * F} -> {'ok' if ok else 'MISMATCH'}")
        check(ok, f"gram_cd M={M} F={F} disagrees with its plain version")
        errs.setdefault("gram_cd", e)

    G, c, beta, db0, lam = tile_inputs(torch, gen, 16, 128, kind="modes")
    modes = blocked_cycle_modes(G, 16)
    seen = sorted(set(modes.flatten().tolist()))
    d = blocked_cd.blocked_cd_kernel(G, c, beta, db0, lam, 1e-6, block=16)
    d0 = ref.blocked_cd_ref(G, c, beta, db0, lam, 1e-6, block=16)
    torch.cuda.synchronize()
    e = max_err(d, d0)
    ok = torch.allclose(d, d0, rtol=TOL, atol=TOL)
    print(f"[kernels] blocked_cd M=16 F=128 B=16 modes {seen}: max|dd| {e:.3g} "
          f"-> {'ok' if ok else 'MISMATCH'}")
    check(seen == [0, 1, 2], f"the modes tile should exercise modes 0, 1, 2; got {seen}")
    check(ok, "blocked_cd disagrees with its plain version")
    errs["blocked_cd"] = e

    G, c, beta, db0, lam = tile_inputs(torch, gen, 16, 128)
    d1 = blocked_cd.blocked_cd_kernel(G, c, beta, db0, lam, 1e-6, block=1)
    ds = gram_cd.gram_cd_kernel(G, c, beta, db0, lam, 1e-6)
    torch.cuda.synchronize()
    same = torch.equal(d1, ds)
    print(f"[kernels] blocked_cd B=1 vs gram_cd: {'bit-equal' if same else 'DIFFERENT'}")
    check(same, "blocked_cd at B=1 is not bit-equal to gram_cd")
    return errs


def phase_main_path(torch):
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
    launches, fits = {}, {}
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
        t2 = time.perf_counter()
        est.fit(DenseDesign(ds.X_train), ds.y_train, lam)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t2
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
    return launches, fits, ds, lam


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
            gpu = LogisticL1(opts, device="cuda").fit(DenseDesign(ds.X_train), ds.y_train, lam)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    engine_syncs = engine.host_syncs
    beta_gpu = gpu.beta.cpu()
    t0 = time.perf_counter()
    cpu = LogisticL1(opts, device="cpu").fit(
        DenseDesign(ds.X_train.cpu()), ds.y_train.cpu(), lam)
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
    stray = {site: stack for site, stack in stacks.items() if not site.startswith("engine.py:")}
    for site, stack in stray.items():
        print(f"[agree] synchronising call at {site}:\n{stack}")
    check(not stray, f"the card fit synchronised outside the engine's host reads: {dict(sites)}")


def phase_times(torch, gen, errs, launches, card):
    from repro_torch.core.subproblem import blocked_cycle_modes
    from repro_torch.kernels import blocked_cd, gram_cd, logistic_stats, ref

    # 1 GB > L2; zeroing it also gives the host time to queue the timed call
    flush = torch.empty(256 * 2 ** 20, device="cuda")
    rows = []
    n = 320_000
    m = 4.0 * torch.randn(n, generator=gen, device="cuda")
    y = torch.where(torch.rand(n, generator=gen, device="cuda") < 0.5, 1.0, -1.0)
    nblk = -(-n // logistic_stats.BLOCK)
    rows.append(("logistic_stats", "triton", "src/repro_torch/kernels/logistic_stats.py",
                 "src/repro/kernels/logistic_stats.py:50",
                 lambda: logistic_stats.logistic_stats_kernel(m, y),
                 lambda: ref.logistic_stats_ref(m, y),
                 16 * n + 4 * nblk, 30 * n))
    M, F = 16, 128
    G, c, beta, db0, lam = tile_inputs(torch, gen, M, F)
    tile_bytes = 4 * (M * F * F + 4 * M * F)
    rows.append(("gram_cd", "cuda", "src/repro_torch/kernels/csrc/gram_cd.cu",
                 "src/repro/kernels/gram_cd.py:66",
                 lambda: gram_cd.gram_cd_kernel(G, c, beta, db0, lam, 1e-6),
                 lambda: ref.gram_cd_ref(G, c, beta, db0, lam, 1e-6),
                 tile_bytes, 2 * M * F * F + 10 * M * F))
    modes = blocked_cycle_modes(G, 16).contiguous()
    h = (G.diagonal(dim1=-2, dim2=-1) + 1e-6).contiguous()
    rows.append(("blocked_cd", "cuda", "src/repro_torch/kernels/csrc/blocked_cd.cu",
                 "src/repro/kernels/blocked_cd.py:132",
                 lambda: blocked_cd.launch_blocked_cd(G, h, c, beta, db0,
                                                      modes, lam, block=16),
                 lambda: ref.blocked_cd_ref(G, c, beta, db0, lam, 1e-6, block=16),
                 tile_bytes + 4 * M * F + 4 * M * (F // 16), 2 * M * F * F + 10 * M * F))
    table = []
    for name, route, source, replaces, kern, plain, n_bytes, n_flops in rows:
        ms = time_ms(torch, kern, flush)
        plain_ms = time_ms(torch, plain, flush)
        b_ms, b_by = bound_ms(n_bytes, n_flops)
        print(f"[times] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}) on {card}")
        if name == "blocked_cd":
            wrap_ms = time_ms(torch, lambda: blocked_cd.blocked_cd_kernel(
                G, c, beta, db0, lam, 1e-6, block=16), flush)
            print(f"[times] blocked_cd with its wrapper's modes and h "
                  f"(plain PyTorch on the card): {wrap_ms:.4f} ms")
        table.append({"name": name, "route": route, "source": source,
                      "replaces": replaces, "launches": launches.get(name, 0),
                      "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return table


def _kind(name: str) -> str:
    low = name.lower()
    if "logistic_stats" in low:
        return "logistic_stats kernel"
    if "gram_cd_kernel" in low or "blocked_cd_kernel" in low:
        return "tile CD kernel"
    if any(k in low for k in ("gemm", "gemv", "xmma", "cutlass", "cublas", "dot_kernel")):
        return "matmul (Gram, c, residual, margins)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other elementwise/reductions (line search, layout, bookkeeping)"


def phase_profile(torch, ds, lam, card):
    """Device time by kernel for one fit in each cycle mode (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import DenseDesign, LogisticL1
    from repro_torch.core.dglmnet import DGLMNETOptions

    for mode in ("sequential", "blocked"):
        est = LogisticL1(DGLMNETOptions(num_blocks=16, tile=128, max_iters=100,
                                        cycle_mode=mode, block=16), device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = est.fit(DenseDesign(ds.X_train), ds.y_train, lam)
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
        busy = sum(r[0] for r in rows)
        if not rows:
            print(f"[profile] {mode}: the profiler recorded no device time")
            continue
        groups = Counter()
        for ms, _, name in rows:
            groups[_kind(name)] += ms
        print(f"[profile] {mode}: {res.n_iters} iters, wall {wall_ms:.1f} ms under the "
              f"profiler, device busy {busy:.1f} ms (idle share {1 - busy / wall_ms:.2f}) "
              f"on {card}")
        for kind, ms in groups.most_common():
            print(f"[profile] {mode}:   {kind}: {ms:.2f} ms ({ms / busy:.1%} of busy)")
        for ms, count, name in rows[:10]:
            print(f"[profile] {mode}:     {ms:8.2f} ms {count:5d}x {name[:90]}")
        for ms, count, name in rows:
            if _kind(name) in ("logistic_stats kernel", "tile CD kernel"):
                print(f"[profile] {mode}: {name[:40]}: {ms / count * 1e3:.1f} us per "
                      f"launch in the fit ({count} launches)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (applies the precision policy)

    t_start = time.perf_counter()
    card = phase_device(torch)
    phase_build(torch)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errs = phase_kernels(torch, gen)
    launches, fits, ds, lam = phase_main_path(torch)
    phase_agreement(torch)
    table = phase_times(torch, gen, errs, launches, card)
    for mode, (wall, wall2, iters, syncs) in fits.items():
        print(f"[times] fit {mode}: {wall:.3f} s whole fit (again {wall2:.3f} s), "
              f"{wall * 1e3 / iters:.2f} ms per outer iteration ({iters} iterations), "
              f"{syncs} host syncs, on {card}")
    try:
        phase_profile(torch, ds, lam, card)
    except Exception as exc:       # instrumentation only, not a checked phase
        print(f"[profile] failed: {exc!r}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
