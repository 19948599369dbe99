"""Fault-tolerant checkpointing of the port, in the reference's layout.

The port's copy of ``repro.checkpoint.store``, byte for byte the same
on disk, so a checkpoint written by either package restores in the
other:

  * ``<dir>/step_%010d/{state.npz, extra.npz, meta.json}`` and
    ``<dir>/manifest.json`` (steps + config hash),
  * atomic: written to ``<dir>/tmp.<step>.<pid>``, fsynced, then
    ``os.replace``-d into place, so a crashed save never corrupts the
    latest checkpoint,
  * keep-N garbage collection,
  * ``SCHEMA_VERSION`` and the config hash are checked on restore.

Trees are flattened by the flat keys of :mod:`repro_torch.checkpoint.
params` (``"a/b/#0/c"``).  The ``.npz`` files are ``np.savez``'s
(stored zip members, ZIP64), written and read one array at a time so
that a full-width checkpoint (tens of GB) streams: tensors leave the
device through ``.detach().cpu().numpy()`` (bfloat16, which numpy lacks,
as float32) while the previous array is written, and
:meth:`CheckpointStore.restore` maps each member's array in place after
checking every member's CRC-32 (the check ``np.load`` makes), returning
numpy arrays that the caller puts on its device.
"""
from __future__ import annotations

import hashlib
import json
import mmap
import os
import shutil
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.params import _flatten, _unflatten

PyTree = Any

#: On-disk layout version, the reference's: v2 carries the elastic state
#: in ``extra`` (streams, detector, deployed code, EF residuals, cluster
#: shrink record).
SCHEMA_VERSION = 2


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _write_member(zf: zipfile.ZipFile, key: str, arr: np.ndarray) -> None:
    """One ``.npy`` member, as ``np.lib.format.write_array`` writes it,
    but its data handed to the zip stream in one piece, not copied out
    in chunks."""
    if not (arr.flags.c_contiguous or arr.flags.f_contiguous):
        arr = np.ascontiguousarray(arr)
    if arr.dtype.hasobject:
        raise ValueError(f"{key}: object arrays are not stored")
    with zf.open(key + ".npy", "w", force_zip64=True) as fid:
        np.lib.format.write_array_header_1_0(
            fid, np.lib.format.header_data_from_array_1_0(arr))
        fid.write(memoryview(arr.ravel(order="K")).cast("B"))


def write_npz(path: str, flat: Dict[str, Any]) -> int:
    """``np.savez(path, **flat)`` for arrays or tensors, one member at a
    time: the next tensor's device → host copy overlaps this array's
    write, and no second host copy of the whole tree is made.  → bytes
    of array data."""
    keys = list(flat)
    nbytes = 0
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf, \
            ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(_host, flat[keys[0]]) if keys else None
        for i, key in enumerate(keys):
            arr = nxt.result()
            if i + 1 < len(keys):
                nxt = pool.submit(_host, flat[keys[i + 1]])
            _write_member(zf, key, arr)
            nbytes += arr.nbytes
            del arr
    return nbytes


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """The arrays of an ``np.savez`` file, mapped in place (copy on
    write) once every member's CRC-32 matches the zip directory's."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        infos = zf.infolist()
        spans = []
        for info in infos:
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed; "
                                 f"checkpoints are np.savez's, stored")
            f.seek(info.header_offset)
            head = f.read(30)  # the local header: name and extra lengths
            start = (info.header_offset + 30
                     + int.from_bytes(head[26:28], "little")
                     + int.from_bytes(head[28:30], "little"))
            spans.append((start, info.file_size, info.CRC))
            f.seek(start)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            if dtype.hasobject:
                raise ValueError(f"{path}: {info.filename} holds objects")
            out[info.filename[:-len(".npy")]] = np.memmap(
                path, dtype=dtype, mode="c", offset=f.tell(), shape=shape,
                order="F" if fortran else "C")
        if infos:
            with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
                view = memoryview(mm)
                try:
                    with ThreadPoolExecutor() as pool:
                        crcs = list(pool.map(
                            lambda sp: zlib.crc32(view[sp[0]:sp[0] + sp[1]]),
                            spans))
                finally:
                    view.release()
            for info, crc, (_, _, want) in zip(infos, crcs, spans):
                if crc != want:
                    raise zipfile.BadZipFile(
                        f"{path}: bad CRC-32 for {info.filename}")
    return out


def config_hash(obj: Any) -> str:
    """The reference's hash of ``repr(obj)``: the port's ``ModelConfig``
    has the reference's repr, so both packages hash a config alike."""
    return hashlib.sha256(
        json.dumps(repr(obj), sort_keys=True).encode()
    ).hexdigest()[:16]


def _is_json(v) -> bool:
    try:
        json.dumps(v)
    except TypeError:
        return False
    return True


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3, cfg_hash: str = ""):
        self.dir = directory
        self.keep = keep
        self.cfg_hash = cfg_hash
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    @property
    def manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def manifest(self) -> Dict:
        if not os.path.exists(self.manifest_path):
            return {"steps": [], "cfg_hash": self.cfg_hash}
        with open(self.manifest_path) as f:
            return json.load(f)

    def _write_manifest(self, man: Dict):
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(man, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.manifest_path)

    # ------------------------------------------------------------------
    def save(self, step: int, state: PyTree,
             extra: Optional[Dict] = None) -> str:
        """Atomic save of a full training state tree (tensors or arrays).

        ``extra`` keys that are JSON-serializable land in meta.json;
        array-valued entries (trees of tensors or arrays, e.g. the EF
        residuals) are flattened into a sibling ``extra.npz``.
        """
        json_extra: Dict = {}
        arr_extra: Dict = {}
        for k, v in (extra or {}).items():
            if _is_json(v):
                json_extra[k] = v
            else:
                arr_extra[k] = v
        tmp_dir = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
        os.makedirs(tmp_dir, exist_ok=True)
        flat = _flatten(state)
        with ThreadPoolExecutor(2) as pool:  # the two files side by side
            state_bytes = pool.submit(
                write_npz, os.path.join(tmp_dir, "state.npz"), flat)
            if arr_extra:
                pool.submit(write_npz, os.path.join(tmp_dir, "extra.npz"),
                            _flatten(arr_extra)).result()
            nbytes = state_bytes.result()
        meta = {
            "step": step,
            "time": time.time(),
            "schema_version": SCHEMA_VERSION,
            "cfg_hash": self.cfg_hash,
            "extra": json_extra,
            "n_arrays": len(flat),
            "bytes": nbytes,
        }
        with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp_dir, final)
        man = self.manifest()
        man["cfg_hash"] = self.cfg_hash
        man["steps"] = sorted(set(man["steps"] + [step]))
        self._write_manifest(man)
        self._gc()
        return final

    def _gc(self):
        man = self.manifest()
        steps = man["steps"]
        while len(steps) > self.keep:
            victim = steps.pop(0)
            d = os.path.join(self.dir, f"step_{victim:010d}")
            if os.path.exists(d):
                shutil.rmtree(d)
        man["steps"] = steps
        self._write_manifest(man)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.manifest()["steps"]
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None
                ) -> Tuple[int, PyTree, Dict]:
        """→ (step, state, extra) as numpy.  Validates the schema version
        and the config hash."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        found = meta.get("schema_version", 1)
        if found != SCHEMA_VERSION:
            raise ValueError(
                f"checkpoint {d} was written with schema v{found}, but "
                f"this build reads v{SCHEMA_VERSION} — the stored "
                f"state/extra layout is incompatible (fields were "
                f"added/removed since).  Restore it with the matching "
                f"release, or re-serialize it before resuming."
            )
        if self.cfg_hash and meta["cfg_hash"] and \
                meta["cfg_hash"] != self.cfg_hash:
            raise ValueError(
                f"checkpoint config hash {meta['cfg_hash']} != "
                f"current {self.cfg_hash}"
            )
        flat = read_npz(os.path.join(d, "state.npz"))
        extra = dict(meta.get("extra", {}))
        extra_path = os.path.join(d, "extra.npz")
        if os.path.exists(extra_path):
            extra.update(_unflatten(read_npz(extra_path)))
        return step, _unflatten(flat), extra
