"""Time the k-buffer walks of one source tree: render_culled on the primary
and first reflected pass of the eval render (chip_smoke.py phase 4: an
800x800 frame of room_scene(100_000), K 32, cluster 256, 192 candidates),
trace_slots on the primary and first reflected pass of the training step's
first batch (phase 5: 768x768, room_scene(175_000), all 72 tiles in one
launch), both as tools/fused_setup.py makes them, then trace_hits on the
first launch of the primary and first reflected pass of the non-fused eval
render (culled) and training step (brute), as chip_smoke.py's phases 11
and 12 make them (tools/nonfused_setup.py), then render_scan on the primary
and first reflected pass of the fast path's frames, as chip_smoke.py's
phase 9 makes them (tools/fused_setup.py fast_path): bench.py's scanq and
its scan (direct) twin, and measure_fps's scanq at the Config defaults.
CUDA events, after one warm-up call.  Needs a CUDA card.

To compare two trees, unpack the other one (`git archive`) into a
directory git ignores and run both in one process sequence, alternating:

    python editable_gaussian_reflections_tpu_torch/tools/walk_ab.py <tree> [<csrc dir>]

<tree> is the root whose package is imported; <csrc dir>, when given,
replaces its csrc/ (a variant of the kernel sources).  The setups are this
script's own tree's, run on <tree>'s package, so that both trees are timed
on the same launches.

    python editable_gaussian_reflections_tpu_torch/tools/walk_ab.py <tree> --slots

times trace_slots' two passes alone (window mode 0, the step's).

    python editable_gaussian_reflections_tpu_torch/tools/walk_ab.py <tree> --cut-walk

times trace_slots' two passes with its walk cut out: a copy of <tree>'s
csrc/ (under <tree>/build/walk_cut/) whose trace_slots kernel fills each
ray's slot columns with K hits on its tile's first listed clusters instead
of walking, so that what is left is the epilogue (the sort, alpha
recomputed, the gathers and the 37 x K row written) at the launch's shapes.

    python editable_gaussian_reflections_tpu_torch/tools/walk_ab.py <tree> --cut-scan=<exp|sums|both>

times only render_scan's passes, built from a copy of <tree>'s csrc/
(under <tree>/build/scan_cut/) whose float64 work per hit is float32
instead: the exp of each valid pair's opacity (exp), the chunk's product
and sums (sums), or both - what they cost of a pass.  The results differ
from the plain version's; they are timed, not checked.
"""

from __future__ import annotations

import importlib.util
import shutil
import sys
from pathlib import Path

# the walk call of csrc/trace_slots.cu, and what --cut-walk puts in its
# place: K hits at depths K..1 on Gaussians of the tile's listed clusters,
# in the slot columns where the walk leaves them (after the stage ring)
WALK_CALL = """  walk_hits<K, CUBE, BACKFACING, EXIT, /*CHUNKS=*/true>(
      p, smem, ray, col_t, col_id, log_t, trav, chunks);"""
NO_WALK = """  col_t = smem + NSTAGE * N_STAGE_ROWS * p.cpad + threadIdx.x;
  col_id = reinterpret_cast<int*>(col_t - threadIdx.x + K * blockDim.x) +
           threadIdx.x;
  log_t = 0.0;
  trav = chunks = 0.0f;
  for (int s = 0; s < K; ++s) {
    const int c = p.cand[(size_t)blockIdx.x * p.mc + s % p.mc];
    col_t[s * blockDim.x] = c < 0 ? INF : (float)(K - s);
    col_id[s * blockDim.x] =
        c < 0 ? 0 : c * p.cluster + (threadIdx.x + 7 * s) % p.cluster;
  }"""


# the float64 work per hit of render_scan, and what --cut-scan puts in its
# place: the opacity's exp (csrc/trace_hits_walk.cuh hit_gaussval) and the
# chunk's product and sums (csrc/render_scan.cu Sum)
SCAN_CUTS = {
    "exp": ("trace_hits_walk.cuh",
            "return (float)exp((double)(-powered / (2.0f * p.exp_power)));",
            "return expf(-powered / (2.0f * p.exp_power));"),
    "sums": ("render_scan.cu", "using Sum = double;", "using Sum = float;"),
}


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _setup(name: str):
    """tools/<name>.py of this script's tree, importing the package of the
    tree on sys.path (the tree timed may predate the module)."""
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).with_name(f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cut_walk_csrc(tree: Path) -> Path:
    """A copy of `tree`'s csrc/ with trace_slots' walk cut out (module
    docstring), under tree/build/walk_cut/csrc."""
    src = tree / "editable_gaussian_reflections_tpu_torch" / "csrc"
    dst = tree / "build" / "walk_cut" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    ts = dst / "trace_slots.cu"
    text = ts.read_text()
    if text.count(WALK_CALL) != 1:
        raise RuntimeError(f"{ts}: the walk call to cut is not there once")
    ts.write_text(text.replace(WALK_CALL, NO_WALK))
    return dst


def cut_scan_csrc(tree: Path, what: str) -> Path:
    """A copy of `tree`'s csrc/ with render_scan's float64 work per hit cut
    to float32 (SCAN_CUTS; "both": every cut), under
    tree/build/scan_cut/csrc."""
    src = tree / "editable_gaussian_reflections_tpu_torch" / "csrc"
    dst = tree / "build" / "scan_cut" / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for name in (SCAN_CUTS if what == "both" else [what]):
        fname, old, new = SCAN_CUTS[name]
        f = dst / fname
        text = f.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{f}: the line to cut is not there once")
        f.write_text(text.replace(old, new))
    return dst


def main(argv: list[str]) -> None:
    tree = Path(argv[0]).resolve()
    root = str(tree)
    sys.path.insert(0, root)
    import torch

    from editable_gaussian_reflections_tpu_torch.ops.cuda import build
    cut = "--cut-walk" in argv[1:]
    slots = cut or "--slots" in argv[1:]
    cut_scan = [a.split("=", 1)[1] for a in argv[1:]
                if a.startswith("--cut-scan=")]
    variant = [a for a in argv[1:] if not a.startswith("--")]
    if cut:
        build.CSRC = cut_walk_csrc(tree)
    elif cut_scan:
        build.CSRC = cut_scan_csrc(tree, cut_scan[0])
    elif variant:  # the library's name hashes the sources it is built from
        build.CSRC = Path(variant[0]).resolve()
    from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
        render_culled)
    from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_slots import (
        trace_slots)
    from editable_gaussian_reflections_tpu_torch.renderer import raytracer as rt
    if not rt.__file__.startswith(root):
        raise RuntimeError(f"imported {rt.__file__}, not the tree {root}")

    dev = torch.device("cuda")
    fs = _setup("fused_setup")
    tag = f"AB {root} {argv[1:]}"
    print(f"{tag}: card [{fs.card()}]", flush=True)
    if cut_scan:
        scan_ab(fs, tag, dev, tree)
        return
    if not slots:
        e = fs.eval_frame(dev)
        rc = {name: [round(cuda_ms(lambda: render_culled(
            *c.args, **c.kwargs), 10), 3) for _ in range(3)]
            for name, c in zip(("primary", "reflected"), e.calls)}
        print(f"{tag}: render_culled ms, 800x800 eval frame (primary "
              f"{rc['primary']}, reflected {rc['reflected']})", flush=True)
        del e
    t = fs.training_step(dev)
    t.steps = t.residuals = t.targets_b = None
    torch.cuda.empty_cache()
    ts = {name: [round(cuda_ms(lambda: trace_slots(*c.args, **c.kwargs), 3),
                       3) for _ in range(2)]
          for name, c in zip(("primary", "reflected"), t.calls)}
    what = "with the walk cut out" if cut else "768x768 step, first batch"
    print(f"{tag}: trace_slots ms, {what} (primary {ts['primary']}, "
          f"reflected {ts['reflected']})", flush=True)
    del t
    torch.cuda.empty_cache()
    print(f"{tag}: card after [{fs.card()}]", flush=True)
    if not slots:
        trace_hits_ab(_setup("nonfused_setup"), tag, dev)
        torch.cuda.empty_cache()
        scan_ab(fs, tag, dev, tree)


def trace_hits_ab(nf, tag: str, dev) -> None:
    """trace_hits' four passes at the chip_smoke.py phase 11/12 shapes
    (`nf`: the module tools/nonfused_setup.py)."""
    from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_hits import (
        trace_hits)

    calls = {"culled": nf.render_trace_calls(nf.eval_render(dev))}
    calls["brute"] = nf.step_trace_calls(nf.training_step(dev))
    res = {}
    for mode in ("brute", "culled"):
        for name, (args, kwargs) in zip(("primary", "reflected"),
                                        calls[mode]):
            if (args[3] is None) != (mode == "brute"):
                raise RuntimeError(f"{mode} {name}: traced the other mode")
            reps = 2 if mode == "brute" else 5
            res[f"{mode} {name}"] = [
                round(cuda_ms(lambda: trace_hits(*args, **kwargs), reps), 3)
                for _ in range(2)]
    print(f"{tag}: trace_hits ms, first launch of {nf.NF_W}x{nf.NF_H} "
          f"({', '.join(f'{k} {v}' for k, v in res.items())})", flush=True)


def scan_ab(fs, tag: str, dev, tree: Path) -> None:
    """render_scan's passes at the chip_smoke.py phase 9 shapes (`fs`: the
    module tools/fused_setup.py)."""
    from editable_gaussian_reflections_tpu_torch.ops.cuda.scan_kernel import (
        render_scan)

    fp = fs.fast_path(dev, str(tree / "build" / "fps_model"))
    res = {}
    for config, calls in fp.calls.items():
        for name, c in zip(("primary", "reflected"), calls):
            if c.kernel.__name__ != "render_scan":
                raise RuntimeError(f"{config} {name}: not a scan pass")
            res[f"{config} {name}"] = [
                round(cuda_ms(lambda: render_scan(*c.args, **c.kwargs), 5), 3)
                for _ in range(2)]
    print(f"{tag}: render_scan ms, {fp.W}x{fp.H} fast path "
          f"({', '.join(f'{k} {v}' for k, v in res.items())})", flush=True)
    print(f"{tag}: card after [{fs.card()}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
