"""PyTorch/CUDA port of editable_gaussian_reflections_tpu.

Module paths mirror the JAX package, so each function's counterpart sits at
the same place.  The port imports torch and never jax; the JAX package stays
the reference that tests/test_torch_*.py hold every ported function against.

Ported so far:
  * the eval render: render_frame_fused in k-buffer mode
    (renderer/raytracer.py), through csrc/render_culled.cu (wrapper:
    ops/cuda/render_kernel.py);
  * the fused training step: training.train_step ->
    raytracer.render_tile_with_grads_fused, through csrc/trace_slots.cu
    (ops/cuda/trace_slots.py) and csrc/scatter_grads.cu (ops/cuda/scatter.py);
  * the inference fast path: measure_fps.py and render_frame_fused with
    composite_mode "scan"/"scanq", through csrc/render_scan.cu
    (ops/cuda/scan_kernel.py), with the scene loading the CLI needs
    (scene/scene.py, scene/cameras.py, dataset/blender.py, utils/ply.py);
  * the non-fused path: render_frame, render(), render_accumulated and
    train_step(use_culling=False) -> raytracer.render_tile_with_grads, the
    frames and steps the fused path cannot take, through csrc/trace_hits.cu
    (ops/cuda/trace_hits.py; brute or culled);
  * the last four Pallas kernels: csrc/render_table.cu, v5's lists on
    csrc/render_culled.cu (ops/cuda/render_fine.py), csrc/bench_dtype.cu
    and csrc/sort_slots.cu, with bench.py's twin and its tools;
  * the CLIs: train.py, render.py, metrics.py, prepare_initial_ply.py,
    measure_fps.py and tools/render_novel_views.py, with the Blender, prior
    and COLMAP dataset layouts;
  * editing and the viewer: scene/editable.py, ops/ellipsoid_raster.py,
    viewer/ (ViewerState, RenderService, the LOCAL shell) and train
    --viewer;
  * the XLA tracer: ops/trace.py trace_rays (ops/intersect.py
    intersect_block, intersect_gathered), the use_pallas=False path of
    render_frame and train_step, in plain PyTorch;
  * the parallel modes on torch.distributed (parallel/): ray data
    parallelism (sharding.py), the Gaussian-sharded trace and step and the
    2D mesh (gaussian_sharded.py), the process mesh and spawn (mesh.py),
    and tools/demo_5m.py.

Entry points build their tensors on the CUDA card unless the caller passes
device="cpu" (device.py); on CPU tensors every kernel wrapper runs its plain
PyTorch version.
"""
