"""Rules of the PyTorch port (src/repro_torch): no JAX, explicit devices,
device-only kernel dispatch, and named refusals for what is not ported."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import smoke_config
from repro_torch.core import QuantPolicy, pack_params, quantize_params
from repro_torch.core.quantize import PackedQTensor
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.msb_matmul import ops as mm_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models import Model
from repro_torch.serve import ContinuousEngine, ServeEngine
from repro_torch.train import AdamW, OptConfig, init_state

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROGRAMS = sorted((ROOT / "examples_torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_compare.py",
    ROOT / "chip_window_mutant.py", ROOT / "chip_unembed_variants.py",
    ROOT / "chip_e2e_profile.py"] + PROGRAMS


def _forbidden_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:                  # relative: inside the package
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top == "jax" or top.startswith("jax") or top == "repro":
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    return bad


def test_port_imports_no_jax_and_nothing_of_repro():
    assert len(PORT_FILES) > 20
    bad = [b for p in PORT_FILES for b in _forbidden_imports(p)]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    """The package and the example programs import, and each program's
    ``--help`` parses, with ``jax`` and ``repro`` blocked."""
    assert len(PROGRAMS) == 5
    load = "".join(
        f"spec = importlib.util.spec_from_file_location('{p.stem}', "
        f"{str(p)!r})\nmod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "try:\n    mod.main(['--help'])\nexcept SystemExit:\n    pass\n"
        for p in PROGRAMS)
    code = ("import sys, importlib.util, contextlib, io\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = "
            "None\nimport repro_torch.serve, repro_torch.convert, "
            "repro_torch.core, repro_torch.kernels._build, "
            "repro_torch.train, repro_torch.data, "
            "repro_torch.launch.train, repro_torch.launch.dryrun\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            + "".join("    " + line + "\n" for line in load.splitlines())
            + "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_call_site_passes_use_kernel_false():
    """The port's dispatchers raise on ``use_kernel=False`` with a CUDA
    tensor (the device decides), which the CPU tests cannot see: so no
    call site of the package passes it."""
    bad = []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Call) and any(
                    kw.arg == "use_kernel" and isinstance(
                        kw.value, ast.Constant) and kw.value.value is False
                    for kw in node.keywords):
                bad.append(f"{path.relative_to(ROOT)}:{node.lineno}")
    assert not bad, bad


def _tiny():
    cfg = smoke_config("internlm2-1.8b")
    return Model(cfg)


ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(None),
    "Model.init": lambda: _tiny().init(torch.Generator()),
    "Model.init_paged_pools": lambda: _tiny().init_paged_pools(4, 2),
    "quantize_params": lambda: quantize_params(
        {"w": torch.zeros(64, 64)}, QuantPolicy(min_size=1)),
    "pack_params": lambda: pack_params({"w": torch.zeros(2)}),
    "ContinuousEngine": lambda: ContinuousEngine(_tiny(), {}),
    "Model.init_cache": lambda: _tiny().init_cache(1, 4),
    "ServeEngine": lambda: ServeEngine(_tiny(), {}, max_seq=8),
    "init_state": lambda: init_state(_tiny(), AdamW(OptConfig()),
                                     torch.Generator()),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_device_none_means_cuda_and_raises_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_cpu_tensors_take_the_plain_versions():
    before = (mm_ops.msb_matmul.launches, mm_ops.msb_unembed.launches,
              pa_ops.paged_attention_decode.launches,
              fa_ops.flash_attention_fwd.launches)
    x = torch.ones(2, 64)
    packed = torch.zeros(64, 32, dtype=torch.uint8)
    scales = torch.ones(64, 1, 8)
    y = mm_ops.msb_matmul(x, packed, scales)
    assert torch.equal(y, torch.full((2, 64), 64.0))
    table = PackedQTensor(packed, scales, 4, 64, torch.float32, 64)
    assert torch.equal(mm_ops.msb_unembed(x, table),
                       torch.full((2, 64), 64.0))
    q = torch.ones(1, 2, 4)
    pool = torch.ones(2, 2, 1, 4)
    out = pa_ops.paged_attention_decode(
        q, pool, pool, torch.ones(1, 1, dtype=torch.int32),
        torch.tensor([2], dtype=torch.int32))
    assert torch.allclose(out, torch.ones(1, 2, 4))
    k = torch.ones(1, 1, 3, 16)
    out = fa_ops.flash_attention_fwd(torch.ones(1, 2, 3, 16), k, k)
    assert torch.allclose(out, torch.ones(1, 2, 3, 16))
    assert (mm_ops.msb_matmul.launches, mm_ops.msb_unembed.launches,
            pa_ops.paged_attention_decode.launches,
            fa_ops.flash_attention_fwd.launches) == before


UNPORTED = {  # engine options the engines refuse, with the reference's
    "parallel": (dict(parallel=object()), TypeError, "ParallelContext"),
    "mesh+parallel": (dict(mesh=object(), parallel=object()), ValueError,
                      "not both"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_engine_options_name_their_roadmap_item(name):
    """Every engine option is served (ROADMAP item 11 closed with GSPMD
    serving); what is left is refused as the reference refuses it: a
    ``parallel=`` that is not a ``ParallelContext`` of a process mesh
    (TypeError), ``mesh=`` with ``parallel=`` (ValueError)."""
    kwargs, error, match = UNPORTED[name]
    with pytest.raises(error, match=match):
        ContinuousEngine(_tiny(), {}, device="cpu", **kwargs)


def test_engines_refuse_a_foreign_mesh():
    """``mesh=`` takes a mesh of ``launch.mesh.make_tp_mesh`` only."""
    with pytest.raises(TypeError, match="make_tp_mesh"):
        ContinuousEngine(_tiny(), {}, device="cpu", mesh=object())


def test_paged_window_runs():
    """The paged path takes a sliding window (gemma2): keys at or below
    ``q_pos - window`` are hidden. Two keys alike, V 1 and 3: the query at
    position 1 averages them without a window and sees only its own key
    with window 1. (The paged path's refusal of the stacks with
    per-sequence state is held in ``tests/test_torch_state_serve.py``.)"""
    from repro_torch.models.attention import paged_attention
    q = torch.ones(1, 1, 2, 16)
    k_pool = torch.ones(2, 2, 1, 16)
    v_pool = torch.ones(2, 2, 1, 16)
    v_pool[1, 1] = 3.0
    args = (q, k_pool, v_pool, torch.ones(1, 1, dtype=torch.int32),
            torch.ones(1, 1, dtype=torch.int32),
            torch.full((1,), 2, dtype=torch.int32))
    assert torch.allclose(paged_attention(*args), torch.full_like(q, 2.0))
    assert torch.allclose(paged_attention(*args, window=1),
                          torch.full_like(q, 3.0))


def test_package_version_and_plain_init_is_seeded():
    assert repro_torch.__version__
    model = _tiny()
    a = model.init(torch.Generator().manual_seed(3), device="cpu")
    b = model.init(torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a["dec"]["s0"]["attn"]["wq"], b["dec"]["s0"]["attn"]["wq"])
    assert np.isfinite(a["embed"].numpy()).all()


def test_cross_attention_names_its_roadmap_item():
    """Cross-attention decode (ROADMAP item 10, now ported) attends every
    row of the static encoder K/V it is given and returns that cache as
    it is: with keys alike and V rows 1 and 3 the output is their mean."""
    from repro_torch.models.layers import attention_layer
    model = _tiny()
    cfg = model.cfg
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    lp = {k: v[0] for k, v in params["dec"]["s0"]["attn"].items()}
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    cache = {"k": torch.ones(1, 2, kv, hd),
             "v": torch.stack([torch.ones(kv, hd), torch.full((kv, hd), 3.0)
                               ])[None]}
    out, new = attention_layer(lp, torch.zeros(1, 1, cfg.d_model), cfg,
                               cache=cache, cross=True)
    assert new is cache
    from repro_torch.models.layers import dense
    want = dense(torch.full((1, 1, cfg.n_heads * hd), 2.0), lp["wo"])
    assert torch.allclose(out, want)
