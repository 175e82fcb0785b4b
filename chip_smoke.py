#!/usr/bin/env python3
"""GPU check of the PyTorch port (manifold_gp_torch) on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):
  1. device: card name and power limit (nvidia-smi), torch/CUDA versions,
     build of the block-ELL SpMV kernel from csrc/ with nvcc (timed);
  2. kernel vs plain at a small layout (10,240-point torus; B = 1, 37, 128):
     f32, bf16 and x3 panels through both entry points (resident/stream);
  3. the slice: serve the 262,144-point torus campaign
     (examples_torch/run_large.py::serve_campaign) with the kernel's launch
     count reset to 0 just before and read just after; requires >= 1,543
     launches, finite outputs and RMSE vs truth below half the label-noise
     floor;
  4. kernel vs plain at the main path's own shapes (the served layout,
     B = 125), with times: kernel (CUDA events, median, through
     cuda_spmv.block_matvec as the basis solve calls it), plain version,
     library yardstick (one torch.bmm over the pre-gathered operand, used
     nowhere in the port) and the bound (bytes or operations at the card's
     published peaks);
  5. the 16,384-point serve held to the JAX package's numbers
     (examples_torch/serve_pins.json).
Then one JSON line with the kernel table, and the last line
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.

Imports nothing of JAX or of the JAX package. Needs CUDA and the rest of
the repository next to this file.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"
BASIS_APPLIES = 4 * 64 * 6 + 6 + 1  # Chebyshev: 4 chunks x 64, +1 RR, x6 iters, +1
SMALL_TOL = 1e-5  # max |kernel - plain| / max |plain|: f32 sum order only
                  # (bf16 and x3 products are exact in f32 on both sides)

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# HBM bytes/s, f32 FLOP/s outside the tensor cores, bf16 tensor FLOP/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),  # SXM (80GB HBM3)
}


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100 (SXM figures; card not in the table)", PEAKS["H100"]


def time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def panel_sets(layout, coeffs):
    import torch

    from manifold_gp_torch.ops.block_sparse import assemble

    return {
        "float32": assemble(layout, coeffs.diag, coeffs.triu),
        "bfloat16": assemble(layout, coeffs.diag, coeffs.triu, dtype=torch.bfloat16),
        "float32x3": assemble(layout, coeffs.diag, coeffs.triu, dtype="float32x3"),
    }


def compare(layout, panels, pv, label, timing=None):
    """Kernel (both entry points) vs plain on the card; returns a record."""
    import torch

    from manifold_gp_torch.ops import cuda_spmv

    bc = layout.block_col.reshape(-1)
    s = layout.max_blocks
    want = cuda_spmv.block_matvec_plain(bc, panels, pv, s_max=s)
    scale = float(want.abs().max())
    rec = {"case": label, "batch": int(pv.shape[1]), "scale": scale}
    for entry in ("resident_matvec_call", "stream_matvec_call"):
        got = getattr(cuda_spmv, entry)(bc, panels, pv, s_max=s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(scale, 1e-30)
        rec[entry] = {"max_abs_err": err, "max_rel_err": rel}
        ok = bool(torch.isfinite(got).all()) and rel <= SMALL_TOL
        print(f"  {label:<34} B={pv.shape[1]:<4} {entry:<21} max_rel_err={rel:.3e} "
              f"(threshold {SMALL_TOL:.0e}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"kernel disagrees with its plain version: {label} {entry} rel={rel}")
    del want
    if timing is not None:
        rec.update(timing(bc, panels, pv, s))
    return rec


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    if not (ROOT / "manifold_gp_torch" / "csrc" / "block_ell_spmv.cu").exists():
        fail(f"the manifold_gp_torch package is not next to {__file__}")
    sys.path.insert(0, str(ROOT))

    from manifold_gp_torch.ops import cuda_spmv
    from manifold_gp_torch.ops.graph import build_graph
    from manifold_gp_torch.ops.block_sparse import build_block_layout, permute_in
    from manifold_gp_torch.ops.laplacian import laplacian_coeffs
    from examples_torch.run_large import serve_campaign, torus_points

    report = {}
    # -- phase 1: device and build ------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output"
    print("== phase 1: device")
    print(smi_line)
    kind = torch.cuda.get_device_name(0)
    peak_key, (hbm_bps, f32_flops, bf16_flops) = peaks_for(kind)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} device {kind} "
          f"(peaks: {peak_key}: {hbm_bps / 1e12} TB/s, f32 {f32_flops / 1e12} TFLOP/s, "
          f"bf16 {bf16_flops / 1e12} TFLOP/s)")
    t0 = time.perf_counter()
    lib_path = cuda_spmv.build_library()
    cuda_spmv._load()
    build_s = time.perf_counter() - t0
    print(f"kernel built in {build_s:.2f} s: {lib_path.relative_to(ROOT)}")
    for line in cuda_spmv.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    report.update(device=kind, nvidia_smi=smi_line, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s, peaks=peak_key)
    dev = torch.device("cuda", 0)

    # -- phase 2: kernel vs plain, small layout -----------------------------
    print("== phase 2: kernel vs plain at a small layout")
    xs, _, _ = torus_points(10_240, seed=1)
    g = build_graph(xs, 16, device=dev)
    small_layout = build_block_layout(g)
    small_coeffs = laplacian_coeffs(g, 0.05)
    print(f"  small layout: N={small_layout.num_nodes} S={small_layout.max_blocks} "
          f"row blocks={small_layout.num_row_blocks}")
    gen = torch.Generator(device=dev).manual_seed(0)
    small = []
    for dtype, panels in panel_sets(small_layout, small_coeffs).items():
        for batch in (1, 37, 128):
            v = torch.randn((small_layout.num_nodes, batch), generator=gen, device=dev)
            small.append(compare(small_layout, panels, permute_in(small_layout, v).contiguous(),
                                 f"small {dtype}"))
    report["small"] = small

    # -- phase 3: the slice at 262,144 points ------------------------------
    print("== phase 3: serve the 262,144-point torus")
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_spmv.launch_count = 0
    result, params, model = serve_campaign(n=262_144, device=dev)
    launches = cuda_spmv.launch_count
    result["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    result["spmv_launches"] = launches
    print("  " + json.dumps(result))
    print(f"  graph {result['graph_build_s']:.2f} s, layout {result['layout_s']:.2f} s, "
          f"basis {result['basis_s']:.2f} s, eval {result['eval_s']:.2f} s; "
          f"S={result['max_blocks']} row blocks={result['num_row_blocks']} "
          f"panels={result['panel_bytes_f32'] / 1e9:.3f} GB; kernel launches={launches}")
    print(f"  test RMSE {result['rmse_noisy_test']:.6f} NLL {result['nll_noisy_test']:.6f} "
          f"RMSE vs truth {result['rmse_vs_truth']:.6f} (noise floor "
          f"{result['noise_floor_rmse']:.6f})")
    report["serve_262k"] = result
    if launches < BASIS_APPLIES:
        fail(f"the SpMV kernel launched {launches} times on the main path (< {BASIS_APPLIES})")
    if not result["finite"]:
        fail("non-finite basis or posterior at 262k")
    if not result["rmse_vs_truth"] < 0.5 * result["noise_floor_rmse"]:
        fail(f"RMSE vs truth {result['rmse_vs_truth']} is not below half the noise floor")

    # -- phase 4: kernel vs plain at the main path's shapes -----------------
    print("== phase 4: kernel vs plain at the main path's shapes (B=125)")
    kernel = model.kernel
    layout = kernel.block_layout
    main_coeffs = kernel.coeffs(params)
    v = torch.randn((layout.num_nodes, 125), generator=gen, device=dev)
    pv = permute_in(layout, v).contiguous()
    del v, model

    def timing(bc, panels, pv, s):
        nrb = layout.num_row_blocks
        b = pv.shape[1]
        x3 = panels.dim() == 4
        macs = nrb * 128 * s * 128 * b
        flops = (3 if x3 else 1) * 2 * macs
        rate = f32_flops if panels.dtype == torch.float32 else bf16_flops
        nbytes = (panels.numel() * panels.element_size() + bc.numel() * 4
                  + pv.numel() * 4 + nrb * 128 * b * 4)
        t_bytes, t_ops = nbytes / hbm_bps * 1e3, flops / rate * 1e3
        ms = time_ms(lambda: cuda_spmv.block_matvec(layout, panels, pv))
        plain_ms = time_ms(lambda: cuda_spmv.block_matvec_plain(bc, panels, pv, s_max=s), reps=3)
        library_ms = None
        if not x3:
            cb = pv.reshape(-1, 128, b).index_select(0, bc).reshape(nrb, s * 128, b)
            cb = cb.to(panels.dtype)
            library_ms = time_ms(lambda: torch.bmm(panels, cb))
            del cb
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes": nbytes, "flops": flops}

    main = []
    for dtype, panels in panel_sets(layout, main_coeffs).items():
        rec = compare(layout, panels, pv, f"main {dtype}", timing=timing)
        del panels
        torch.cuda.empty_cache()
        print(f"    ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
              f"library_ms={rec['library_ms']} bound_ms={rec['bound_ms']:.4f} "
              f"({rec['bound_by']})")
        main.append(rec)
    report["main"] = main

    # -- phase 5: 16,384 points against the JAX package's numbers ----------
    print("== phase 5: serve 16,384 points, held to the JAX pins")
    pins = json.loads((ROOT / "examples_torch" / "serve_pins.json").read_text())
    r16, _, _ = serve_campaign(n=pins["n"], device=dev, num_test=pins["num_test"])
    checks = {}
    for key in ("rmse_vs_truth", "rmse_noisy_test", "nll_noisy_test"):
        rel = abs(r16[key] - pins[key]) / abs(pins[key])
        checks[key] = {"port": r16[key], "jax": pins[key], "rel": rel}
        print(f"  {key}: port {r16[key]:.7f} jax {pins[key]:.7f} rel {rel:.2e} "
              f"(rtol {pins['rtol']})")
        if not rel <= pins["rtol"]:
            fail(f"16k {key} differs from the JAX pin by {rel:.2e} > {pins['rtol']}")
    for key in ("num_edges", "max_blocks", "num_row_blocks"):
        if r16[key] != pins[key]:
            fail(f"16k {key}: port {r16[key]} != JAX {pins[key]}")
    report["serve_16k"] = {"result": r16, "checks": checks}

    # -- result --------------------------------------------------------------
    f32 = main[0]
    kernels = [{
        "name": "block_ell_spmv",
        "route": "cuda",
        "source": "manifold_gp_torch/csrc/block_ell_spmv.cu",
        "replaces": "manifold_gp_tpu/ops/pallas_spmv.py:207",
        "also_replaces": "manifold_gp_tpu/ops/pallas_spmv.py:126",
        "launches": launches,
        "max_abs_err": f32["stream_matvec_call"]["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "panels": "float32",
        "shape": [layout.num_row_blocks, layout.max_blocks, 125],
    }]
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1))
    print(f"total {report['total_s']:.1f} s; details in {OUT.relative_to(ROOT)}")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
