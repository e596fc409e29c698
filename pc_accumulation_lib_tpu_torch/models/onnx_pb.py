"""Minimal ONNX ModelProto reader + writer (no ``onnx`` package required).

The port's own copy of models/onnx_pb.py (numpy only). An .onnx file is a
protobuf ModelProto, and the subset the weight loader needs (graph
initializers: name, dims, data_type, raw/typed data; node op types,
inputs and outputs) is small enough to read with a hand-rolled protobuf
wire-format scanner, so no ``onnx`` package is needed on the card machine
or anywhere else. ``read_graph`` feeds models/onnx_port.load_onnx_weights;
``write_initializers`` emits the same field subset, so a model's weights
can be exported as a file standard ONNX tooling reads, and tests can
synthesize real graph files (Identity-alias nodes, every typed encoding).

Wire format (protobuf encoding spec): a message is a sequence of
(tag varint = field_number << 3 | wire_type, payload) records;
wire types used by ONNX: 0 = varint, 1 = 64-bit, 2 = length-delimited,
5 = 32-bit. Field numbers below are from onnx.proto3:

  ModelProto:  graph = 7 (GraphProto)
  GraphProto:  node = 1, initializer = 5 (TensorProto), name = 2
  TensorProto: dims = 1 (repeated int64), data_type = 2, float_data = 4,
               int32_data = 5, int64_data = 7, name = 8, raw_data = 9,
               double_data = 10, uint64_data = 11
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype (the subset exporters emit for
# weights; bf16 (16) has no numpy dtype and is not used by torch exports).
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    end = len(buf)
    while True:
        if pos >= end:
            raise ValueError('truncated protobuf (varint past buffer end)')
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError('varint too long (corrupt protobuf)')


def _fields(buf: memoryview) -> Iterator[Tuple[int, int, memoryview]]:
    """Yield (field_number, wire_type, payload view) over one message.
    Raises ValueError (never a bare IndexError or a silently short view)
    on a truncated or corrupt buffer."""
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            if pos + n > end:
                raise ValueError(
                    f'truncated protobuf: field {field} length {n} '
                    f'exceeds buffer ({end - pos} bytes left)')
            yield field, wire, buf[pos:pos + n]
            pos += n
        elif wire == 5:
            if pos + 4 > end:
                raise ValueError('truncated protobuf (fixed32 past end)')
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:
            if pos + 8 > end:
                raise ValueError('truncated protobuf (fixed64 past end)')
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f'unsupported wire type {wire} '
                             f'(field {field})')


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    """TensorProto -> (name, ndarray)."""
    name = ''
    dims = []
    data_type = 1
    raw = None
    # Typed repeated scalar fields arrive packed (one wire-2 chunk) OR
    # unpacked (one record per element) — the protobuf spec requires
    # accepting both. Fixed-width elements (float/double) collect as raw
    # bytes either way; varint elements collect as chunks (packed) plus
    # decoded ints (unpacked).
    typed = {4: [], 5: [], 7: [], 10: [], 11: []}
    unpacked_ints = {5: [], 7: [], 11: []}
    for field, wire, val in _fields(buf):
        if field == 1:                       # dims (packed or unpacked)
            if wire == 0:
                dims.append(val)
            else:
                pos = 0
                while pos < len(val):
                    d, pos = _read_varint(val, pos)
                    dims.append(d)
        elif field == 2:
            data_type = val
        elif field == 8:
            name = bytes(val).decode('utf-8')
        elif field == 9:
            raw = val
        elif field in typed:
            if wire in (1, 2, 5):            # packed chunk / fixed-width
                typed[field].append(bytes(val))
            elif wire == 0:                  # unpacked varint element
                unpacked_ints[field].append(val)
    if data_type not in _DTYPES:
        raise ValueError(f'initializer {name!r}: unsupported '
                         f'data_type {data_type}')
    dtype = _DTYPES[data_type]

    def varint_values(field, bits):
        vals = []
        for chunk in typed[field]:
            mv, pos = memoryview(chunk), 0
            while pos < len(mv):
                v, pos = _read_varint(mv, pos)
                vals.append(v)
        vals.extend(unpacked_ints[field])
        # Proto varints are sign-extended to 64 bits (int32 -1 arrives as
        # 2^64-1). Mask to 64 then to the target width BEFORE the two's-
        # complement adjust so every element is an in-range python int —
        # otherwise np.asarray can promote a mixed list to float64 and
        # silently corrupt values.
        half, width_mask = 1 << (bits - 1), (1 << bits) - 1
        vals = [(v & ((1 << 64) - 1)) & width_mask for v in vals]
        return [v - (1 << bits) if v >= half else v for v in vals]

    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif typed[4] and data_type == 1:
        arr = np.frombuffer(b''.join(typed[4]), dtype=np.float32)
    elif typed[10] and data_type == 11:
        arr = np.frombuffer(b''.join(typed[10]), dtype=np.float64)
    elif (typed[7] or unpacked_ints[7]) and data_type == 7:
        arr = np.asarray(varint_values(7, 64), dtype=np.int64)
    elif ((typed[5] or unpacked_ints[5])
          and data_type in (2, 3, 4, 5, 6, 9, 10)):
        out = varint_values(5, 32)
        if data_type == 10:                  # float16 stored as uint16
            arr = np.asarray(out, np.int64).astype(
                np.uint16).view(np.float16)
        else:
            arr = np.asarray(out).astype(dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    return name, arr.reshape(dims) if dims else arr


_NP_TO_DT = {np.dtype(v): k for k, v in _DTYPES.items()}


def _enc_varint(v: int) -> bytes:
    """Protobuf varint encoding (non-negative int)."""
    if v < 0:
        raise ValueError('varint payloads must be pre-masked non-negative')
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _rec(field: int, wire: int, payload) -> bytes:
    tag = _enc_varint(field << 3 | wire)
    if wire == 0:
        return tag + _enc_varint(payload)
    if wire == 2:
        return tag + _enc_varint(len(payload)) + bytes(payload)
    raise ValueError(f'unsupported writer wire type {wire}')


def _tensor_bytes(name: str, arr: np.ndarray, encoding: str) -> bytes:
    """TensorProto wire bytes for one named array.

    encoding='raw' stores the array as raw_data (field 9) — what real
    exporters emit for weights. encoding='typed' uses the repeated typed
    fields (float_data/int32_data/int64_data) with proto-conformant
    packing, exercising the reader's other branches: negative varints are
    sign-extended to 64 bits exactly like protoc does."""
    arr = np.ascontiguousarray(arr)
    dt = _NP_TO_DT.get(arr.dtype)
    if dt is None:
        raise ValueError(f'initializer {name!r}: unsupported dtype '
                         f'{arr.dtype}')
    out = bytearray()
    for d in arr.shape:
        out += _rec(1, 0, int(d))            # dims (unpacked varints)
    out += _rec(2, 0, dt)                    # data_type
    out += _rec(8, 2, name.encode('utf-8'))  # name
    if encoding == 'raw':
        out += _rec(9, 2, arr.tobytes())     # raw_data
    elif encoding == 'typed':
        flat = arr.reshape(-1)
        if dt == 1:                          # float_data, packed fixed32
            out += _rec(4, 2, flat.tobytes())
        elif dt == 11:                       # double_data, packed fixed64
            out += _rec(10, 2, flat.tobytes())
        elif dt == 7:                        # int64_data, packed varints
            payload = b''.join(_enc_varint(int(v) & ((1 << 64) - 1))
                               for v in flat)
            out += _rec(7, 2, payload)
        elif dt in (2, 3, 4, 5, 6, 9, 10):   # int32_data, packed varints
            ints = (flat.view(np.uint16) if dt == 10
                    else flat).astype(np.int64)
            payload = b''.join(_enc_varint(int(v) & ((1 << 64) - 1))
                               for v in ints)
            out += _rec(5, 2, payload)
        else:
            raise ValueError(f'typed encoding unsupported for dtype {dt}')
    else:
        raise ValueError(f'unknown encoding {encoding!r}')
    return bytes(out)


def write_graph(path: str, named: Dict[str, np.ndarray], nodes=(),
                encoding: str = 'raw') -> None:
    """Write an ONNX ModelProto with initializers AND a node list — the
    exact inverse of ``read_graph`` (same onnx.proto3 field subset),
    needing no ``onnx`` package. ``nodes`` is an iterable of
    ``(op_type, inputs, outputs)`` tuples in topological order, the same
    record shape ``read_graph`` returns, so a graph can be read,
    transformed, and written back hermetically (tests synthesize whole
    exporter universes this way for the structural matcher)."""
    graph = bytearray()
    for name, arr in named.items():
        graph += _rec(5, 2, _tensor_bytes(name, arr, encoding))
    for op, ins, outs in nodes:
        node = bytearray()
        for t in ins:
            node += _rec(1, 2, t.encode('utf-8'))    # NodeProto.input
        for t in outs:
            node += _rec(2, 2, t.encode('utf-8'))    # NodeProto.output
        node += _rec(4, 2, op.encode('utf-8'))       # NodeProto.op_type
        graph += _rec(1, 2, bytes(node))             # GraphProto.node
    graph += _rec(2, 2, b'graph')                    # GraphProto.name
    model = (_rec(1, 0, 8)                           # ModelProto.ir_version
             + _rec(7, 2, bytes(graph)))             # ModelProto.graph
    with open(path, 'wb') as f:
        f.write(model)


def write_initializers(path: str, named: Dict[str, np.ndarray],
                       identities=(), encoding: str = 'raw') -> None:
    """Write {name: ndarray} as an ONNX ModelProto — the exact inverse of
    ``read_initializers`` (same onnx.proto3 field subset), needing no
    ``onnx`` package. ``identities`` is an iterable of (src, dst) pairs
    emitted as Identity nodes, mirroring exporter weight deduplication.
    Lets tests synthesize real graph files hermetically, and gives the
    framework an export path consumable by standard ONNX tooling."""
    write_graph(path, named,
                nodes=[('Identity', [src], [dst])
                       for src, dst in identities],
                encoding=encoding)


def read_graph(path: str):
    """Read an .onnx file as ``(initializers, nodes)``: the graph
    initializers as {name: ndarray} plus every node as an
    ``(op_type, inputs, outputs)`` tuple in file order (the ONNX spec
    requires nodes to be topologically sorted). The node list feeds the
    structural (dataflow) weight matcher in models/onnx_port, which
    recovers tensor roles when an exporter renames every initializer.

    ``Identity`` aliases are resolved into the initializer dict:
    exporters deduplicate value-identical tensors by emitting one
    initializer plus Identity(src) -> alias nodes (e.g. a fresh
    BatchNorm's running_var aliasing its all-ones weight) — the alias
    names are restored so porting sees every tensor."""
    with open(path, 'rb') as f:
        data = f.read()
    model = memoryview(data)
    named: Dict[str, np.ndarray] = {}
    nodes = []                               # (op_type, inputs, outputs)
    for field, wire, graph in _fields(model):
        if field != 7 or wire != 2:          # ModelProto.graph
            continue
        for gfield, gwire, msg in _fields(graph):
            if gfield == 5 and gwire == 2:   # GraphProto.initializer
                name, arr = _parse_tensor(msg)
                named[name] = arr
            elif gfield == 1 and gwire == 2:  # GraphProto.node
                op, ins, outs = '', [], []
                for nfield, nwire, v in _fields(msg):
                    if nfield == 1:
                        ins.append(bytes(v).decode('utf-8'))
                    elif nfield == 2:
                        outs.append(bytes(v).decode('utf-8'))
                    elif nfield == 4:
                        op = bytes(v).decode('utf-8')
                nodes.append((op, ins, outs))
    # Nodes are topologically sorted, so one pass resolves alias chains.
    for op, ins, outs in nodes:
        if (op == 'Identity' and len(ins) == 1 and len(outs) == 1
                and ins[0] in named and outs[0] not in named):
            named[outs[0]] = named[ins[0]]
    if not named:
        raise ValueError(f'{path}: no graph initializers found '
                         '(not an ONNX ModelProto?)')
    return named, nodes


def read_initializers(path: str) -> Dict[str, np.ndarray]:
    """Read an .onnx file's graph initializers as {name: ndarray}."""
    return read_graph(path)[0]
