"""Carry the JAX package's parameters over to this port.

Inputs are plain numpy arrays (or anything `np.asarray` takes), so
nothing here imports JAX:
  * `params_tree`: HuMoR / VPoser parameter pytrees (nested dicts and
    lists of arrays) -> the same structure of torch tensors;
  * `smpl_model`: an object with SmplModel's fields (v_template,
    shapedirs, posedirs, j_regressor, lbs_weights, parents, faces,
    vtx_joint_ids) -> humor_torch's SmplModel;
  * `gmm_params`: (weights, means, covs) -> GmmParams;
  * `load_checkpoint`: the npz files humor_tpu/utils/checkpoint.py
    writes (msgpack-serialized pytrees in flax's encoding), decoded by
    the small msgpack reader below; `encode_pytree` is the matching
    writer (humor_torch.utils.checkpoint).
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

from humor_torch.body_model.smpl import SmplModel
from humor_torch.models.gmm import GmmParams


def params_tree(tree: Any, device="cpu") -> Any:
    """Nested dicts/lists/tuples of arrays -> the same of float32 tensors."""
    if isinstance(tree, dict):
        return {k: params_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_tree(v, device) for v in tree]
    return torch.as_tensor(np.array(tree, np.float32), device=device)


def smpl_model(model: Any, device="cpu") -> SmplModel:
    t = lambda name: torch.as_tensor(
        np.array(getattr(model, name), np.float32), device=device)
    i32 = lambda name: np.array(getattr(model, name), np.int32)
    return SmplModel(v_template=t("v_template"), shapedirs=t("shapedirs"),
                     posedirs=t("posedirs"), j_regressor=t("j_regressor"),
                     lbs_weights=t("lbs_weights"), parents=i32("parents"),
                     faces=i32("faces"), vtx_joint_ids=i32("vtx_joint_ids"))


def gmm_params(weights, means, covs, device="cpu") -> GmmParams:
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)
    return GmmParams(t(weights), t(means), t(covs))


# ---------------------------------------------------------------------------
# Checkpoints: flax msgpack state dicts inside an npz
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """Minimal msgpack decoder: nil/bool/int/float/str/bin/array/map and
    flax's ndarray extension."""

    def __init__(self, data: bytes):
        self.d = memoryview(data)
        self.i = 0

    def _take(self, n: int) -> bytes:
        b = bytes(self.d[self.i:self.i + n])
        if len(b) != n:
            raise ValueError("truncated msgpack data")
        self.i += n
        return b

    def _u(self, fmt: str) -> int:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def read(self) -> Any:
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self._take(t & 0x1F).decode()
        if t >= 0xE0:
            return t - 0x100
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        if t in (0xC4, 0xC5, 0xC6):
            return self._take(self._u({0xC4: ">B", 0xC5: ">H",
                                       0xC6: ">I"}[t]))
        if t in (0xC7, 0xC8, 0xC9):
            n = self._u({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            return self._ext(self._u(">b"), self._take(n))
        if 0xD4 <= t <= 0xD8:
            code = self._u(">b")
            return self._ext(code, self._take(1 << (t - 0xD4)))
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fmts:
            return self._u(fmts[t])
        if t in (0xD9, 0xDA, 0xDB):
            n = self._u({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t])
            return self._take(n).decode()
        if t in (0xDC, 0xDD):
            n = self._u(">H" if t == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self._map(self._u(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k.decode() if isinstance(k, bytes) else k] = self.read()
        return out

    @staticmethod
    def _ext(code: int, data: bytes) -> Any:
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension {code}")
        shape, dtype, buf = _Reader(data).read()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


class _Writer:
    """Minimal msgpack encoder for what flax.serialization.to_bytes
    emits: maps with str keys, ints, floats, bools, None, and numpy
    arrays as the ndarray extension ((shape, dtype name, C bytes))."""

    def __init__(self):
        self.out = bytearray()

    def _head(self, n: int, fix: int, fix_max: int, codes) -> None:
        if n <= fix_max:
            self.out.append(fix | n)
        elif n < 1 << 16:
            self.out += struct.pack(">BH", codes[0], n)
        else:
            self.out += struct.pack(">BI", codes[1], n)

    def _bin(self, b: bytes) -> None:
        n = len(b)
        if n < 1 << 8:
            self.out += struct.pack(">BB", 0xC4, n)
        elif n < 1 << 16:
            self.out += struct.pack(">BH", 0xC5, n)
        else:
            self.out += struct.pack(">BI", 0xC6, n)
        self.out += b

    def _ext(self, code: int, b: bytes) -> None:
        n = len(b)
        if n in (1, 2, 4, 8, 16):
            self.out += struct.pack(">Bb", 0xD4 + (n.bit_length() - 1), code)
        elif n < 1 << 8:
            self.out += struct.pack(">BBb", 0xC7, n, code)
        elif n < 1 << 16:
            self.out += struct.pack(">BHb", 0xC8, n, code)
        else:
            self.out += struct.pack(">BIb", 0xC9, n, code)
        self.out += b

    def write(self, x: Any) -> "_Writer":
        if x is None:
            self.out.append(0xC0)
        elif isinstance(x, (bool, np.bool_)):
            self.out.append(0xC3 if x else 0xC2)
        elif isinstance(x, int):
            if 0 <= x <= 0x7F or -32 <= x < 0:
                self.out += struct.pack(">b" if x < 0 else ">B", x)
            elif x >= 0:
                self.out += struct.pack(">BQ", 0xCF, x)
            else:
                self.out += struct.pack(">Bq", 0xD3, x)
        elif isinstance(x, float):
            self.out += struct.pack(">Bd", 0xCB, x)
        elif isinstance(x, str):
            b = x.encode()
            if len(b) < 32:
                self.out.append(0xA0 | len(b))
            else:
                self._head(len(b), 0, -1, (0xDA, 0xDB))
            self.out += b
        elif isinstance(x, bytes):
            self._bin(x)
        elif isinstance(x, (list, tuple)):
            self._head(len(x), 0x90, 0x0F, (0xDC, 0xDD))
            for v in x:
                self.write(v)
        elif isinstance(x, dict):
            self._head(len(x), 0x80, 0x0F, (0xDE, 0xDF))
            for k, v in x.items():
                self.write(k)
                self.write(v)
        elif isinstance(x, np.ndarray):
            arr = np.ascontiguousarray(x)
            inner = _Writer().write([list(arr.shape), arr.dtype.name,
                                     arr.tobytes()]).out
            self._ext(_EXT_NDARRAY, bytes(inner))
        else:
            raise TypeError(f"cannot msgpack {type(x).__name__}")
        return self


def _state_dict(tree: Any) -> Any:
    """flax's state dict: lists become {"0": .., "1": ..}, tensors numpy."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def encode_pytree(tree: Any) -> bytes:
    """Nested dicts/lists of tensors or arrays -> the bytes
    flax.serialization.to_bytes writes for the same pytree (arrays of at
    most flax's 2**30-byte chunk size)."""
    return bytes(_Writer().write(_state_dict(tree)).out)


def _lists_back(tree: Any) -> Any:
    """flax stores lists as {"0": .., "1": ..}: turn them back."""
    if not isinstance(tree, dict):
        return tree
    tree = {k: _lists_back(v) for k, v in tree.items()}
    if tree and all(isinstance(k, str) and k.isdigit() for k in tree) \
            and sorted(int(k) for k in tree) == list(range(len(tree))):
        return [tree[str(i)] for i in range(len(tree))]
    return tree


def decode_pytree(data: bytes) -> Any:
    """flax.serialization.to_bytes output -> nested dicts/lists of numpy
    arrays."""
    return _lists_back(_Reader(data).read())


def load_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """A humor_tpu checkpoint npz -> {"params": torch pytree, "epoch",
    "min_train_loss", "min_val_loss"} (optimizer state is not read)."""
    with np.load(path, allow_pickle=False) as raw:
        return {
            "params": params_tree(decode_pytree(raw["params"].tobytes()),
                                  device),
            "epoch": int(raw["epoch"]),
            "min_train_loss": float(raw["min_train_loss"]),
            "min_val_loss": float(raw["min_val_loss"]),
        }
