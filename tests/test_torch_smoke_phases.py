"""tools/smoke_phases.py: a stamped chip_smoke.py log read phase by phase
(exact sums of the stamps' differences, to 1e-9 s)."""

import pytest

from editable_gaussian_reflections_tpu_torch.tools import smoke_phases

LOG = """100.0 smoke_phases: start build/ab/change
160.0 phase 1: card [NVIDIA H100 80GB HBM3, 700.00 W]; built 8 kernels
161.5 phase 1: render_culled.cu ptxas: 102 registers
170.0 phase 2: cuda vs cpu
175.0 a line of a tool's own output
190.0 phase 5: trace_slots
200.0 phase 5b: exit mode 1
230.0 phase 23 (f): card vs CPU
230.5 {"ok": true}
"""


def test_phase_seconds():
    secs = smoke_phases.phase_seconds(LOG.splitlines())
    assert list(secs) == [1, 2, 5, 23, "total"]
    want = {1: 61.5, 2: 8.5, 5: 30.0, 23: 30.0, "total": 130.5}
    for k, v in want.items():
        assert secs[k] == pytest.approx(v, abs=1e-9)
    rep = smoke_phases.report("change", secs)
    assert rep["before_last"] == pytest.approx(100.0, abs=1e-9)


def test_read_mode_and_unstamped_log(tmp_path, capsys):
    log = tmp_path / "change.log"
    log.write_text(LOG)
    assert smoke_phases.main(["read", str(log)]) == 0
    assert "total 130.5 s" in capsys.readouterr().out
    with pytest.raises(ValueError, match="start line"):
        smoke_phases.phase_seconds(LOG.splitlines()[1:])
