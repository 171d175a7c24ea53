"""Atomic, resumable checkpoints in the reference's on-disk format.

Port of ``repro.train.checkpoint`` on one device. Layout: ``<dir>/step_<n>/``
with one ``leaf_%05d.npy`` per leaf, numbered in sorted key order, and
``MANIFEST.json`` ({"step", "leaves": {key: {"file", "shape", "dtype",
"crc32"}}}); keys are the reference's ``tree_flatten_with_path`` names
(``params/dec/s0/attn/wq``, ``opt/m/.../q``, ``opt/step``). Either package
restores the other's checkpoints: the files are byte for byte what the
reference writes for the same arrays.

* atomic: written to ``step_<n>.tmp``, fsynced, then renamed;
* integrity: each leaf's crc32 over its raw bytes, checked on load;
* async: ``save`` snapshots every tensor to host memory first (a copy, so
  the next step may update the tensors in place), then writes on a
  background thread;
* ``restore(like=...)`` places each leaf on the device (and in the
  nesting) of ``like``'s.

bf16 leaves: the reference writes them through ml_dtypes, so the file's
dtype descriptor is ``'<V2'`` (raw 2-byte words) and the manifest says
``"bfloat16"``. Without ml_dtypes, the port writes the tensor's bits
viewed as int16 under that same header, and reads any ``"bfloat16"`` leaf
back by viewing its 2-byte words as ``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch

_BF16_DESCR = "<V2"


def _flatten(tree, prefix=""):
    """Nested dict -> {"a/b/c": leaf}, the reference's key names."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _to_host(t):
    """A tensor -> (a numpy copy of its bytes on the host, the manifest's
    dtype name); bf16 as int16 words (written under the ``'<V2'``
    header)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _c_order(arr):
    """``arr`` C-contiguous, 0-d kept 0-d (``np.ascontiguousarray`` would
    make it 1-d)."""
    return arr if arr.flags.c_contiguous else arr.copy(order="C")


def _save_npy(path, arr, dtype_name):
    arr = _c_order(arr)
    if dtype_name != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def _to_tensor(arr, dtype_name, device):
    if dtype_name == "bfloat16":
        words = _c_order(arr).view(np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


class Checkpointer:
    def __init__(self, directory, keep=3, async_save=True):
        self.dir = str(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(self.dir, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, state, step, block=False):
        """Snapshot ``state`` (a nested dict of tensors) to host memory now
        and write it as ``step_<step>`` (on a background thread unless
        ``block`` or ``async_save=False``)."""
        host = {k: _to_host(v) for k, v in _flatten(state).items()}
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(host, step), daemon=True)
            self._thread.start()
        else:
            self._write(host, step)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host, step):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": int(step), "leaves": {}}
        for i, (key, (arr, dtype_name)) in enumerate(sorted(host.items())):
            fn = f"leaf_{i:05d}.npy"
            _save_npy(os.path.join(tmp, fn), arr, dtype_name)
            manifest["leaves"][key] = {
                "file": fn, "shape": list(arr.shape), "dtype": dtype_name,
                "crc32": zlib.crc32(_c_order(arr).tobytes()) & 0xFFFFFFFF,
            }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "MANIFEST.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, step, like=None, verify=True):
        """Load ``step``. Without ``like``: ({key: CPU tensor}, step).
        With ``like`` (a nested dict of tensors): the same nesting, each
        leaf on its ``like`` leaf's device. Raises ``IOError`` on a crc
        mismatch."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        raw = {}
        for key, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(path, meta["file"]))
            if verify:
                crc = zlib.crc32(arr.tobytes()) & 0xFFFFFFFF
                if crc != meta["crc32"]:
                    raise IOError(f"checkpoint corruption in {key}")
            raw[key] = (arr, meta["dtype"])
        if like is None:
            return ({k: _to_tensor(a, dt, "cpu") for k, (a, dt)
                     in raw.items()}, manifest["step"])

        def build(node, prefix):
            out = {}
            for k, v in node.items():
                key = f"{prefix}{k}"
                if isinstance(v, dict):
                    out[k] = build(v, key + "/")
                else:
                    arr, dt = raw[key]
                    out[k] = _to_tensor(arr, dt, v.device)
            return out

        return build(like, ""), manifest["step"]

    def restore_latest(self, like=None):
        steps = self.steps()
        if not steps:
            return None
        return self.restore(steps[-1], like=like)
