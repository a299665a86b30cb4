"""tools/shard_tiling.py on the CPU at a small size: the 64x64 k-buffer frame
of room_scene(4096) at the Config's transmittance threshold, whole and as
2 ray shards (the plain versions of the kernels).  Some reflected rays part
between the two; the primary step never does, and the replay of a ray
alone reproduces both frames' outputs on rays that do not part."""

from __future__ import annotations

import json

from editable_gaussian_reflections_tpu_torch.tools import shard_tiling


def test_shard_tiling_cpu(tmp_path):
    out = tmp_path / "tiling.json"
    rec = shard_tiling.main(["--n", "4096", "--side", "64", "--threshold",
                             "0.01", "--device", "cpu", "--max-rays", "3",
                             "--out", str(out)])
    assert json.loads(out.read_text()) == rec
    assert rec["controls"] == shard_tiling.N_CONTROL
    assert rec["controls_reproduced"] == rec["controls"]
    assert rec["rays_outside"] > 0 and rec["rays_replayed"] == 3
    assert sum(rec["first_parting"].values()) == 3
    assert all(ray["step"] >= 1 for ray in rec["rays"])
