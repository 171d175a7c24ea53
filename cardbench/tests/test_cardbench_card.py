"""On the card only: each served cell's control at the cell's own size,
one seed, a short window (``cardbench.control``): the program's widest
logit gap stays under the cell's limit and the fp8 control's lies over
it. Run on the chip with ``PYTHONPATH=src python -m pytest -q -m cuda
cardbench/tests``."""
import pytest

from cardbench import manifest

SERVE = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", SERVE)
def test_control_fails_where_the_program_passes(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cardbench import run
    res = manifest.resolve(workload)
    if res["traffic"]["driver"] != "closed_loop":
        pytest.skip("the control test covers the served cells")
    out = run.run_cell(workload, 2 ** 32 + 5, 6.0, 0, control=True,
                       resolved=res)
    limit = res["data"]["limits"]["logit_gap"]
    assert out["correct"], out["checks"]
    assert out["notes"]["control_logit_gap"] > limit
