"""PyTorch port vs the root tools/denoiser_eval.py and tools/denoise_train.py.

Both sides render room_scene(2048) where the tools hard-code
room_scene(100_000) (each side patches its own utils.synth.room_scene),
on the fused k-buffer path (K 32, cluster 128, 128 candidates): JAX in
interpret mode, the port on the CPU fed the samples JAX draws (a render
seeded s takes fold_in(PRNGKey(s), i) for its sample i).  The JAX child dispatches every sample of a
render_accumulated_chunked call on its own (render_accumulated_fused at
spp 1 with the sample's key_offset: the same sample stream, summed in
float64 rather than in float32 per chunk), so that interpret mode compiles
one frame instead of one per spp.

  * denoiser_eval at --size 16 --ref_spp 4 --spp 1 2: every PSNR within
    0.05 dB of the JAX JSON's, every gain within 0.05 dB (both round to
    0.01 dB).
  * denoise_train --gen on 2 views at 16x16, reference 4 spp: every array
    of the npz within test_torch_backend.py's frame rule (at most 0.5% of
    elements outside 2e-4*|ref| + 2e-5*scale).
  * denoise_train --train for 3 steps at crop 8 on JAX's --gen npz, from
    JAX's init_params(PRNGKey(0)) carried across as numpy, each step's and
    the validation's crops JAX's (PRNGKey(i + 1), PRNGKey(0)): each step's
    loss within 1e-5 relative of JAX's; each step's gradient of every
    tensor within 1e-4 of that tensor's largest JAX gradient; the learning
    rates equal to the values optax's cosine_decay_schedule gave to 1e-7;
    the report's best step equal and its val L1s (5 decimals) within
    1e-5; the weights written load back with denoise_net.load_params.
  * --weights inside the JAX package is refused, and the shipped
    assets/denoise_kpn_v1.npz keeps its sha256.
  * Without a card and without --device cpu both tools exit non-zero.
The JAX side runs in a child process capped at AVX (see
test_torch_render_frame.py).
"""

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.renderer import denoise_net as tdn
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.tools import (
    denoise_train as tdt,
)
from editable_gaussian_reflections_tpu_torch.tools import (
    denoiser_eval as tde,
)
from editable_gaussian_reflections_tpu_torch.utils import synth as tsynth
from tests.test_torch_room_dataset import (
    child_env,
    jax_samples_fed,
    mismatch,
    root_module,
    run_child,
    sample_keys,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ROOM_N = 2048
EVAL_ARGV = ["--size", "16", "--ref_spp", "4", "--spp", "1", "2"]
GEN_ARGV = ["--gen", "--size", "16", "--views", "2", "--ref_spp", "4"]
TRAIN_STEPS, CROP = 3, 8
ASSET = ROOT / "editable_gaussian_reflections_tpu" / "assets" / \
    "denoise_kpn_v1.npz"
PSNR_DB = 0.05
FRAME_SHARE = 0.005


def _eval_keys():
    return (sample_keys(tde.REF_SEED, 4) + sample_keys(tde.SEED, 1)
            + sample_keys(tde.SEED, 2))


def _gen_keys():
    return [k for v in range(2) for k in (
        sample_keys(10_000 + v, 4) + sample_keys(v * 17, 1)
        + sample_keys(v * 17 + 1, 1))]


def jax_crops(seed, batch, height, width, crop):
    """The crop corners the root tool draws from PRNGKey(seed)."""
    import jax

    key = jax.random.PRNGKey(seed)
    cy = jax.random.randint(key, (batch,), 0, height - crop)
    cx = jax.random.randint(jax.random.fold_in(key, 1), (batch,), 0,
                            width - crop)
    return (torch.tensor(np.asarray(cy), dtype=torch.int64),
            torch.tensor(np.asarray(cx), dtype=torch.int64))


@contextlib.contextmanager
def jax_patched():
    """The root tools' room shrunk to ROOM_N rows, and every fused
    render_accumulated_chunked dispatched a sample at a time in interpret
    mode (module docstring)."""
    import jax

    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.utils import synth

    real_room = synth.room_scene

    def chunked(scene, camera, settings, key, width, height, spp=128,
                spp_chunk=16, *, fused=True, **kw):
        assert fused
        acc = None
        for i in range(spp):
            out = jrt.render_accumulated_fused(
                scene, camera, settings, key, width, height, spp=1,
                key_offset=i, interpret=True, **kw)
            part = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64) / spp, out)
            acc = part if acc is None else jax.tree_util.tree_map(
                lambda a, b: a + b, acc, part)
        return jax.tree_util.tree_map(lambda a: a.astype(np.float32), acc)

    with mock.patch.object(synth, "room_scene",
                           lambda n, **kw: real_room(ROOM_N, **kw)), \
            mock.patch.object(jrt, "render_accumulated_chunked", chunked):
        yield


def jax_train_reference(out: Path):
    """The root tool's train() for TRAIN_STEPS steps from JAX's
    init_params(PRNGKey(0)), recording (through jax.debug.callback, inside
    its jitted step) each step's loss and gradients and each learning rate
    optax's schedule gives."""
    import argparse

    import jax
    import optax

    from editable_gaussian_reflections_tpu.renderer import denoise_net as jdn

    root = root_module("denoise_train", "tools/denoise_train.py")
    np.savez(out / "params0.npz", **{
        k: np.asarray(v) for k, v in jdn.init_params(
            jax.random.PRNGKey(0)).items()})
    steps, lrs = [], []
    real_vg, real_sched = jax.value_and_grad, optax.cosine_decay_schedule

    def record_step(loss, grads):
        steps.append((float(loss), {k: np.asarray(v)
                                    for k, v in grads.items()}))

    def value_and_grad(fn, *a, **k):
        vg = real_vg(fn, *a, **k)

        def wrapped(*args):
            loss, grads = vg(*args)
            jax.debug.callback(record_step, loss, grads, ordered=True)
            return loss, grads
        return wrapped

    def schedule(*a, **k):
        sched = real_sched(*a, **k)

        def wrapped(count):
            lr = sched(count)
            jax.debug.callback(lambda x: lrs.append(float(x)), lr,
                               ordered=True)
            return lr
        return wrapped

    args = argparse.Namespace(
        data=str(out / "jax_data.npz"), weights=str(out / "jax_w.npz"),
        steps=TRAIN_STEPS, lr=2e-3, crop=CROP)
    printed = io.StringIO()
    with mock.patch.object(jax, "value_and_grad", value_and_grad), \
            mock.patch.object(optax, "cosine_decay_schedule", schedule), \
            contextlib.redirect_stdout(printed):
        root.train(args)
        jax.effects_barrier()
    report = json.loads(printed.getvalue().strip().splitlines()[-1])
    assert len(steps) == len(lrs) == TRAIN_STEPS
    np.savez(out / "train_ref.npz", loss=np.array([s[0] for s in steps]),
             lr=np.array(lrs), **{f"grad{i}/{k}": v for i, (_, g) in
                                  enumerate(steps) for k, v in g.items()})
    (out / "train_report.json").write_text(json.dumps(report))


def jax_runs(out: str):
    out = Path(out)
    os.environ.pop(tdn.WEIGHTS_ENV, None)
    with jax_patched():
        root_module("denoiser_eval", "tools/denoiser_eval.py").main(
            ["--out", str(out / "jax_eval.json")] + EVAL_ARGV)
        sys.argv = ["denoise_train", "--data", str(out / "jax_data.npz"),
                    "--weights", str(out / "unused.npz")] + GEN_ARGV
        root_module("denoise_train", "tools/denoise_train.py").main()
    jax_train_reference(out)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    out = tmp_path_factory.mktemp("denoise_tools")
    run_child(__file__, out)
    return out


@pytest.fixture
def small_room():
    real = tsynth.room_scene
    with mock.patch.object(tsynth, "room_scene",
                           lambda n, **kw: real(ROOM_N, **kw)), \
            mock.patch.dict(os.environ):
        os.environ.pop(tdn.WEIGHTS_ENV, None)
        yield


def test_denoiser_eval_matches_root(jax_out, small_room, tmp_path):
    out = tmp_path / "port_eval.json"
    with jax_samples_fed(_eval_keys()):
        tde.main(["--out", str(out), "--device", "cpu"] + EVAL_ARGV)
    ours = json.loads(out.read_text())
    theirs = json.loads((jax_out / "jax_eval.json").read_text())
    assert (ours["size"], ours["ref_spp"]) == (theirs["size"],
                                               theirs["ref_spp"])
    assert list(ours["results"]) == list(theirs["results"]) == ["1", "2"]
    for spp, row in theirs["results"].items():
        assert list(ours["results"][spp]) == list(row)
        for k, v in row.items():
            assert abs(ours["results"][spp][k] - v) <= PSNR_DB + 1e-9, (
                spp, k, ours["results"][spp][k], v)


def test_denoise_train_gen_matches_root(jax_out, small_room, tmp_path):
    data = tmp_path / "port_data.npz"
    with jax_samples_fed(_gen_keys()):
        tdt.main(["--data", str(data), "--device", "cpu"] + GEN_ARGV)
    ours, theirs = np.load(data), np.load(jax_out / "jax_data.npz")
    assert sorted(ours.files) == sorted(theirs.files)
    assert int(ours["noisy_per_view"]) == int(theirs["noisy_per_view"]) == 2
    for k in ("ref",) + tdt.FIELDS:
        a, b = ours[k], theirs[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert np.isfinite(a).all(), k
        assert mismatch(a, b) <= FRAME_SHARE, (k, mismatch(a, b))


def test_denoise_train_steps_match_root(jax_out, tmp_path):
    ref = np.load(jax_out / "train_ref.npz")
    report = json.loads((jax_out / "train_report.json").read_text())
    with np.load(jax_out / "params0.npz") as p:
        params0 = {k: torch.tensor(p[k]) for k in p.files}
    weights = tmp_path / "w.npz"
    args = tdt.parse_args(["--train", "--data", str(jax_out / "jax_data.npz"),
                           "--weights", str(weights), "--steps",
                           str(TRAIN_STEPS), "--crop", str(CROP),
                           "--device", "cpu"])
    grads = []
    real_step = torch.optim.Adam.step

    def step(opt, *a, **k):
        grads.append([p.grad.detach().clone() for p in
                      opt.param_groups[0]["params"]])
        return real_step(opt, *a, **k)

    with mock.patch.object(tdt, "draw_crops", jax_crops), \
            mock.patch.object(torch.optim.Adam, "step", step):
        ours = tdt.train(args, torch.device("cpu"), params=params0)
    names = list(params0)
    assert len(grads) == TRAIN_STEPS == len(ours["history"]["loss"])
    np.testing.assert_allclose(ours["history"]["loss"], ref["loss"],
                               rtol=1e-5, atol=0)
    for i, step_grads in enumerate(grads):
        for name, g in zip(names, step_grads):
            theirs = ref[f"grad{i}/{name}"]
            scale = float(np.abs(theirs).max())
            err = float(np.abs(g.numpy() - theirs).max())
            assert err <= 1e-4 * scale, (i, name, err, scale)
    np.testing.assert_allclose(ours["history"]["lr"], ref["lr"], rtol=0,
                               atol=1e-7)
    assert ours["best_step"] == report["best_step"]
    for k in ("val_l1_init", "val_l1"):
        assert abs(ours[k] - report[k]) <= 1e-5 + 1e-12, (k, ours[k],
                                                          report[k])
    back = tdn.load_params(str(weights))
    assert sorted(back) == sorted(names)


def test_seeds_part_cpu_sample_streams():
    """The CPU generator keeps a seed's low 32 bits: fold_in mixes the
    render's seed into them, so denoiser_eval's reference (seed 999) and
    its frames (seed 0) draw different samples on the CPU too; seed 0's
    sample i keeps seed i, and the seeds of distinct (seed, sample) pairs
    stay distinct."""
    def us(seed, i):
        gen = torch.Generator().manual_seed(trt.fold_in(seed, i))
        return trt.draw_samples(gen, 8, 8, 2).us

    for i in range(3):
        assert not torch.equal(us(tde.REF_SEED, i), us(tde.SEED, i))
        assert trt.fold_in(0, i) == i
    pairs = [(s, i) for s in (0, 1, 2, 999, 10_000, 2**31 - 1)
             for i in (0, 1, 255, 2**32 - 1)]
    assert len({trt.fold_in(s, i) for s, i in pairs}) == len(pairs)
    assert len({trt.fold_in(s, i) & 0xFFFFFFFF for s, i in pairs
                if i < 3}) == len([p for p in pairs if p[1] < 3])


def _sha256(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def test_weights_inside_the_jax_package_are_refused(tmp_path):
    before = _sha256(ASSET)
    inside = [str(ASSET), "editable_gaussian_reflections_tpu/assets/x.npz",
              str(ROOT / "editable_gaussian_reflections_tpu_torch" / ".."
                  / "editable_gaussian_reflections_tpu" / "k.npz"),
              str(ROOT / "editable_gaussian_reflections_tpu")]
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        for path in inside:
            with pytest.raises(ValueError, match="inside the JAX package"):
                tdt.main(["--train", "--weights", path, "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert tdt.check_weights_path(str(tmp_path / "w.npz"))
    assert tdt.parse_args([]).weights == tdt.DEFAULT_WEIGHTS
    assert _sha256(ASSET) == before


def test_tools_need_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tde.main(["--out", str(tmp_path / "e.json")] + EVAL_ARGV)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdt.main(["--data", str(tmp_path / "d.npz")] + GEN_ARGV)
    for tool in ("denoiser_eval", "denoise_train"):
        done = subprocess.run(
            [sys.executable, "-m", "editable_gaussian_reflections_tpu_torch."
             f"tools.{tool}", "--size", "16"], env=child_env(),
            capture_output=True, text=True, timeout=300)
        assert done.returncode != 0 and "device='cpu'" in done.stderr, tool
    assert not list(tmp_path.iterdir())


if __name__ == "__main__":
    jax_runs(sys.argv[1])
