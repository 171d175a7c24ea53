"""Both drivers end to end on the CPU at a smoke size (``smoke.py``):
the program agrees with the plain reference (its codes exactly, its
served tokens within the cells' own limits), the fp8 control reads
wider than the program, and a run whose timed path is broken underneath
comes out not correct: a served token altered where the engine hands it
out, a packed code altered."""
import pytest
import torch

from cardbench import manifest
from cardbench.tests import smoke

MANIFEST = manifest.load_manifest()
SERVE = [w["name"] for w in MANIFEST["workloads"]
         if manifest.resolve(w["name"], MANIFEST)["traffic"]["driver"]
         == "closed_loop"]
MOE = next(w["name"] for w in MANIFEST["workloads"]
           if w["config"] == "granite-moe-3b-a800m")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", SERVE)
def test_served_cell_agrees_with_the_reference(workload):
    out = smoke.run_smoke(smoke.resolved(workload), control=True)
    assert out["checks"]["codes_mismatch"]["value"] == 0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["notes"]["checked_tokens"] > 0
    assert out["correct"], out["checks"]
    assert out["notes"]["control_logit_gap"] > \
        3 * out["checks"]["logit_gap"]["value"]


@pytest.mark.parametrize("workload", SERVE)
def test_altered_token_is_not_correct(workload, monkeypatch):
    from repro_torch.serve import ContinuousEngine
    real = ContinuousEngine.stream_updates

    def altered(self):
        out = real(self)
        for rid, (toks, done) in out.items():
            if toks:
                toks[0] = (toks[0] + 1) % self.model.cfg.vocab_size
        return out

    monkeypatch.setattr(ContinuousEngine, "stream_updates", altered)
    out = smoke.run_smoke(smoke.resolved(workload))
    assert out["checks"]["codes_mismatch"]["value"] == 0
    assert not out["correct"]


def test_altered_code_is_not_correct(monkeypatch):
    from repro_torch.core import quantize
    real = quantize.pack_codes_int4

    def flipped(codes):
        packed = real(codes)
        packed[0] ^= 0x1
        return packed

    monkeypatch.setattr(quantize, "pack_codes_int4", flipped)
    out = smoke.run_smoke(smoke.resolved(SERVE[0]))
    assert out["checks"]["codes_mismatch"]["value"] > 0
    assert not out["correct"]


def test_moe_loop_agrees_where_no_expert_can_overflow():
    """The MoE cell through the closed loop at its own chunk and session
    count, shrunk: with a capacity factor of padded experts over top-k
    no expert's slots can overflow, so the f32 program serves exactly
    the dropless reference's tokens."""
    out = smoke.run_smoke(smoke.resolved(MOE), seconds=1.0)
    assert out["checks"]["codes_mismatch"]["value"] == 0
    assert out["notes"]["checked_tokens"] > 0
    assert out["checks"]["logit_gap"]["value"] == 0.0
