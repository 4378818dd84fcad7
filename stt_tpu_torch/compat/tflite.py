"""Reference `.tflite` model-artifact interop (import side).

The reference's released models are TFLite flatbuffers with an API
boundary of named tensors — `input_node`, `previous_state_c/h`,
`input_samples`, `logits`, `new_state_c/h`, `mfccs` — plus `metadata_*`
constant outputs carrying graph version, audio geometry, beam width and
the serialized alphabet (training/coqui_stt_training/export.py:57-77,
deepspeech_model.py:266-403; consumed by name in
native_client/tflitemodelstate.cc:211-303).

This module reads that artifact WITHOUT TensorFlow: a minimal
flatbuffer parser for the TFLite schema (tables/vtables/vectors are a
few dozen lines) plus a structural walk of the op graph. Weight matrices
can't be found by name — the MLIR converter renames and transposes them
into FULLY_CONNECTED operands — so the importer follows dataflow from
`input_node`: the first three FULLY_CONNECTED weights are layers 1-3,
the one applied repeatedly inside the unrolled static_rnn is the LSTM
kernel (stored [4H, 2H], transposed back to the reference checkpoint's
[2H, 4H] icfo layout), and the final two are layers 5-6. INT8
dynamic-range-quantized weights (export.py:146 Optimize.DEFAULT) are
dequantized per output channel.

The port's copy of `stt_tpu.compat.tflite` (pure numpy). Gate:
tests/test_torch_compat.py reads the port's and stt_tpu's exports with
both importers and holds the imported weights, metadata and geometry
equal, and the TFLite interpreter's logits against the port's forward.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# -- minimal flatbuffer access ----------------------------------------------


class _FB:
    """Read-only flatbuffer primitives over a bytes object."""

    def __init__(self, data: bytes):
        self.d = data

    def u8(self, pos):
        return self.d[pos]

    def i8(self, pos):
        return struct.unpack_from("<b", self.d, pos)[0]

    def u16(self, pos):
        return struct.unpack_from("<H", self.d, pos)[0]

    def u32(self, pos):
        return struct.unpack_from("<I", self.d, pos)[0]

    def i32(self, pos):
        return struct.unpack_from("<i", self.d, pos)[0]

    def i64(self, pos):
        return struct.unpack_from("<q", self.d, pos)[0]

    def f32(self, pos):
        return struct.unpack_from("<f", self.d, pos)[0]

    def root(self) -> int:
        return self.u32(0)

    def field(self, table: int, fid: int) -> Optional[int]:
        """Absolute position of field `fid` in `table`, or None."""
        vtable = table - self.i32(table)
        vsize = self.u16(vtable)
        slot = 4 + 2 * fid
        if slot >= vsize:
            return None
        off = self.u16(vtable + slot)
        if off == 0:
            return None
        return table + off

    def indirect(self, pos: int) -> int:
        return pos + self.u32(pos)

    def table_field(self, table: int, fid: int) -> Optional[int]:
        p = self.field(table, fid)
        return None if p is None else self.indirect(p)

    def string_field(self, table: int, fid: int) -> Optional[str]:
        p = self.field(table, fid)
        if p is None:
            return None
        s = self.indirect(p)
        n = self.u32(s)
        return self.d[s + 4 : s + 4 + n].decode("utf-8", "replace")

    def vector(self, table: int, fid: int) -> Optional[Tuple[int, int]]:
        """(element-0 position, length) of a vector field."""
        p = self.field(table, fid)
        if p is None:
            return None
        v = self.indirect(p)
        return v + 4, self.u32(v)

    def vector_tables(self, table: int, fid: int) -> List[int]:
        v = self.vector(table, fid)
        if v is None:
            return []
        base, n = v
        return [self.indirect(base + 4 * i) for i in range(n)]

    def vector_i32(self, table: int, fid: int) -> np.ndarray:
        v = self.vector(table, fid)
        if v is None:
            return np.zeros(0, np.int32)
        base, n = v
        return np.frombuffer(self.d, "<i4", n, base).copy()

    def vector_i64(self, table: int, fid: int) -> np.ndarray:
        v = self.vector(table, fid)
        if v is None:
            return np.zeros(0, np.int64)
        base, n = v
        return np.frombuffer(self.d, "<i8", n, base).copy()

    def vector_f32(self, table: int, fid: int) -> np.ndarray:
        v = self.vector(table, fid)
        if v is None:
            return np.zeros(0, np.float32)
        base, n = v
        return np.frombuffer(self.d, "<f4", n, base).copy()

    def vector_bytes(self, table: int, fid: int) -> bytes:
        v = self.vector(table, fid)
        if v is None:
            return b""
        base, n = v
        return self.d[base : base + n]

    def scalar_i32(self, table: int, fid: int, default=0) -> int:
        p = self.field(table, fid)
        return default if p is None else self.i32(p)

    def scalar_i8(self, table: int, fid: int, default=0) -> int:
        p = self.field(table, fid)
        return default if p is None else self.i8(p)

    def scalar_u32(self, table: int, fid: int, default=0) -> int:
        p = self.field(table, fid)
        return default if p is None else self.u32(p)


# TFLite TensorType enum (schema.fbs)
_DTYPES = {
    0: np.float32,
    1: np.float16,
    2: np.int32,
    3: np.uint8,
    4: np.int64,
    6: np.bool_,
    7: np.int16,
    9: np.int8,
}
TENSOR_TYPE_STRING = 5

# BuiltinOperator codes used in the reference graph
OP_FULLY_CONNECTED = 9
OP_RESHAPE = 22
OP_SOFTMAX = 25


class Tensor:
    def __init__(self, fb: _FB, t: int, buffers):
        self.name = fb.string_field(t, 3) or ""
        self.shape = fb.vector_i32(t, 0).tolist()
        self.type = fb.scalar_i8(t, 1, 0)
        self.buffer_index = fb.scalar_u32(t, 2, 0)
        self._buffers = buffers
        q = fb.table_field(t, 4)
        self.scale = self.zero_point = None
        self.quantized_dimension = 0
        if q is not None:
            scale = fb.vector_f32(q, 2)
            zp = fb.vector_i64(q, 3)
            if len(scale):
                self.scale = scale
                self.zero_point = zp if len(zp) else np.zeros(1, np.int64)
                self.quantized_dimension = fb.scalar_i32(q, 6, 0)

    @property
    def raw(self) -> bytes:
        return self._buffers[self.buffer_index]

    def data(self) -> Optional[np.ndarray]:
        """Materialize a constant tensor (dequantized to f32 for int8
        weight tensors); None for non-constant (empty buffer)."""
        raw = self.raw
        if not raw:
            return None
        if self.type == TENSOR_TYPE_STRING:
            raise ValueError("use .strings() for string tensors")
        arr = np.frombuffer(raw, _DTYPES[self.type]).reshape(self.shape)
        if self.type == 9 and self.scale is not None:  # INT8 quantized
            scale = self.scale
            zp = self.zero_point.astype(np.float32)
            if len(scale) == 1:
                return (arr.astype(np.float32) - zp[0]) * scale[0]
            dim = self.quantized_dimension
            bshape = [1] * arr.ndim
            bshape[dim] = len(scale)
            return (arr.astype(np.float32) - zp.reshape(bshape)) * (
                scale.reshape(bshape)
            )
        return arr

    def strings(self) -> List[bytes]:
        """Decode the TFLite string-tensor buffer layout: i32 count,
        i32 offsets[count+1], payload."""
        raw = self.raw
        (n,) = struct.unpack_from("<i", raw, 0)
        offs = struct.unpack_from(f"<{n + 1}i", raw, 4)
        return [raw[offs[i] : offs[i + 1]] for i in range(n)]


class Operator:
    def __init__(self, fb: _FB, op: int, opcodes):
        self.opcode = opcodes[fb.scalar_u32(op, 0, 0)]
        self.inputs = fb.vector_i32(op, 1).tolist()
        self.outputs = fb.vector_i32(op, 2).tolist()


class TFLiteModel:
    """Parsed top level of a .tflite flatbuffer (first subgraph)."""

    def __init__(self, data: bytes):
        if data[4:8] != b"TFL3":
            raise ValueError("not a TFLite flatbuffer (missing TFL3 magic)")
        fb = _FB(data)
        root = fb.root()
        self.version = fb.scalar_u32(root, 0, 0)
        buffers = [
            fb.vector_bytes(b, 0) for b in fb.vector_tables(root, 4)
        ]
        opcodes = []
        for oc in fb.vector_tables(root, 1):
            code = fb.scalar_i8(oc, 0, 0)  # deprecated_builtin_code
            code32 = fb.scalar_i32(oc, 3, 0)
            opcodes.append(max(code, code32))
        sub = fb.vector_tables(root, 2)[0]
        self.tensors = [
            Tensor(fb, t, buffers) for t in fb.vector_tables(sub, 0)
        ]
        self.inputs = fb.vector_i32(sub, 1).tolist()
        self.outputs = fb.vector_i32(sub, 2).tolist()
        self.operators = [
            Operator(fb, op, opcodes) for op in fb.vector_tables(sub, 3)
        ]

    @classmethod
    def from_file(cls, path: str) -> "TFLiteModel":
        with open(path, "rb") as f:
            return cls(f.read())

    def tensor_by_name(self, name: str) -> Optional[Tensor]:
        for t in self.tensors:
            if t.name == name:
                return t
        return None

    def output_by_name(self, name: str) -> Optional[Tensor]:
        for i in self.outputs:
            if self.tensors[i].name == name:
                return self.tensors[i]
        return None


# -- reference-model import --------------------------------------------------


def read_metadata(model: TFLiteModel) -> Dict:
    """The metadata_* constant outputs (tflitemodelstate.cc:220-303)."""
    meta: Dict = {}
    for key in ("metadata_version", "metadata_sample_rate",
                "metadata_feature_win_len", "metadata_feature_win_step",
                "metadata_beam_width"):
        t = model.output_by_name(key)
        if t is not None and t.raw:
            meta[key[len("metadata_"):]] = int(t.data()[0])
    t = model.output_by_name("metadata_alphabet")
    if t is not None and t.raw:
        meta["alphabet_serialized"] = t.strings()[0]
    t = model.output_by_name("metadata_language")
    if t is not None and t.raw:
        meta["language"] = t.strings()[0].decode("utf-8", "replace")
    return meta


def _fc_chain_from(model: TFLiteModel, start_tensor: int):
    """All FULLY_CONNECTED ops reachable (dataflow) from start_tensor, in
    the subgraph's (topological) operator order."""
    reachable = {start_tensor}
    chain = []
    for op in model.operators:
        if any(i in reachable for i in op.inputs if i >= 0):
            reachable.update(op.outputs)
            if op.opcode == OP_FULLY_CONNECTED:
                chain.append(op)
    return chain


def read_reference_tflite(path: str):
    """-> (params pytree, metadata dict, geometry dict).

    Structural import: see module docstring. Works for both f32 and
    dynamic-range-quantized (int8 weight) reference exports.
    """
    model = TFLiteModel.from_file(path)
    input_node = None
    for i in model.inputs:
        if model.tensors[i].name == "input_node":
            input_node = i
    if input_node is None:
        raise ValueError(f"{path}: no input_node tensor — not a "
                         "reference STT export")
    b, n_steps, window, n_input = model.tensors[input_node].shape
    fcs = _fc_chain_from(model, input_node)
    # group by weight tensor id: layers appear once, the LSTM kernel 16x
    by_weight: Dict[int, List[Operator]] = {}
    order: List[int] = []
    for op in fcs:
        w = op.inputs[1]
        if w not in by_weight:
            by_weight[w] = []
            order.append(w)
        by_weight[w].append(op)
    dense_ids = [w for w in order if len(by_weight[w]) == 1]
    rnn_ids = [w for w in order if len(by_weight[w]) > 1]
    if len(dense_ids) != 5 or len(rnn_ids) != 1:
        raise ValueError(
            f"{path}: unexpected graph structure "
            f"({len(dense_ids)} dense FCs, {len(rnn_ids)} recurrent)"
        )

    def fc_params(w_id):
        ops = by_weight[w_id]
        w = model.tensors[w_id].data()  # [out, in] FC layout
        bias_id = ops[0].inputs[2] if len(ops[0].inputs) > 2 else -1
        bias = (
            model.tensors[bias_id].data()
            if bias_id >= 0 and model.tensors[bias_id].raw
            else np.zeros(w.shape[0], np.float32)
        )
        return (
            np.ascontiguousarray(w.T, np.float32),
            np.asarray(bias, np.float32),
        )

    names = ["layer_1", "layer_2", "layer_3", "layer_5", "layer_6"]
    params: Dict = {}
    for name, w_id in zip(names, dense_ids):
        w, bias = fc_params(w_id)
        params[name] = {"w": w, "b": bias}
    kernel, kbias = fc_params(rnn_ids[0])  # back to [2H, 4H] icfo
    params["lstm"] = {"kernel": kernel, "bias": kbias}

    n_cell = params["lstm"]["kernel"].shape[1] // 4
    geometry = {
        "n_input": int(n_input),
        "n_context": (int(window) - 1) // 2,
        "n_hidden": params["layer_1"]["w"].shape[1],
        "n_cell_dim": int(n_cell),
        "n_out": params["layer_6"]["w"].shape[1],
        "n_steps": int(n_steps),
        "layer_norm": False,
    }
    return params, read_metadata(model), geometry
