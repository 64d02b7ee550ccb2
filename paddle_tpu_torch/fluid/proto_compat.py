"""Reference-format (protobuf) program and parameter serialization.

The reference stores programs as a binary ``ProgramDesc`` protobuf
(``framework/framework.proto:184``) in ``__model__`` files, and parameters
as versioned LoDTensor streams (``framework/lod_tensor.cc:222``
SerializeToStream / ``framework/tensor_util.cc:379`` TensorToStream).
This module implements both wire formats from scratch — a minimal proto2
codec over the transcribed field schema, not generated code — so models
saved by the reference load here and vice versa.

Schema field numbers are transcribed from ``framework.proto``.  This is
the port's own copy of ``paddle_tpu/fluid/proto_compat.py``: the same
program built in both packages serializes to the same bytes, and each
package parses the other's (``tests/test_torch_proto_compat.py``).
bfloat16 (tag 22) travels as its 2-byte payload (``data_types.BF16_HOST``)
without ml_dtypes.
"""

import struct

import numpy as np

from . import framework
from .data_types import host_dtype_name, host_np_dtype
from .framework import Parameter, Program

# --------------------------------------------------------------- wire core

_WT_VARINT, _WT_64BIT, _WT_LEN, _WT_32BIT = 0, 1, 2, 5


def _enc_varint(out, v):
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _dec_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed(v, bits=64):
    if v >= 1 << (bits - 1) if bits < 64 else v >= 1 << 63:
        v -= 1 << 64
    return v


def _enc_tag(out, field, wt):
    _enc_varint(out, (field << 3) | wt)


def _enc_bytes(out, field, data):
    _enc_tag(out, field, _WT_LEN)
    _enc_varint(out, len(data))
    out.extend(data)


def _enc_field(out, field, kind, v):
    if kind == "varint":           # ints / bools / enums (two's complement)
        _enc_tag(out, field, _WT_VARINT)
        _enc_varint(out, int(v))
    elif kind == "float":
        _enc_tag(out, field, _WT_32BIT)
        out.extend(struct.pack("<f", float(v)))
    elif kind == "bytes":
        _enc_bytes(out, field, v.encode() if isinstance(v, str) else v)
    else:
        raise AssertionError(kind)


def _dec_fields(buf):
    """Yield (field, wiretype, value) over a message buffer; LEN values are
    memoryview slices, varints are raw unsigned ints."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _dec_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == _WT_VARINT:
            v, pos = _dec_varint(buf, pos)
        elif wt == _WT_LEN:
            ln, pos = _dec_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == _WT_32BIT:
            v = buf[pos:pos + 4]
            pos += 4
        elif wt == _WT_64BIT:
            v = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError("bad wire type %d at %d" % (wt, pos))
        yield field, wt, v


def _f32(v):
    return struct.unpack("<f", bytes(v))[0]


# ----------------------------------------------------- enum value mappings

# AttrType (framework.proto:26)
_A_INT, _A_FLOAT, _A_STRING, _A_INTS, _A_FLOATS, _A_STRINGS = range(6)
_A_BOOLEAN, _A_BOOLEANS, _A_BLOCK, _A_LONG, _A_BLOCKS, _A_LONGS = range(6, 12)

# VarType.Type (framework.proto:105).  BF16=22 follows the post-1.5
# reference proto numbering (the repo's own VarType.BF16, data_types.py) so
# pure-bf16 programs export/round-trip; a 1.5-line reference reader simply
# has no code 22, same as any newer-dtype model.
_VT_DTYPE = {0: "bool", 1: "int16", 2: "int32", 3: "int64", 4: "float16",
             5: "float32", 6: "float64", 20: "uint8", 21: "int8",
             22: "bfloat16"}
_DTYPE_VT = {v: k for k, v in _VT_DTYPE.items()}
_VT_LOD_TENSOR = 7
_VT_SELECTED_ROWS = 8
_VT_FEED_MINIBATCH = 9
_VT_FETCH_LIST = 10
_VT_STEP_SCOPES = 11
_VT_LOD_TENSOR_ARRAY = 13
_VT_READER = 15
_VT_RAW = 17

# framework.VariableType string names used by this repo's Variable.type
_VT_BY_NAME = {
    "tensor": _VT_LOD_TENSOR, "selected_rows": _VT_SELECTED_ROWS,
    "tensor_array": _VT_LOD_TENSOR_ARRAY, "reader": _VT_READER,
    "raw": _VT_RAW, "feed_minibatch": _VT_FEED_MINIBATCH,
    "fetch_list": _VT_FETCH_LIST,
}
_NAME_BY_VT = {v: k for k, v in _VT_BY_NAME.items()}
_NAME_BY_VT[_VT_STEP_SCOPES] = "raw"


# ------------------------------------------------------------ attr codec

def _classify_attr(v):
    """Python attr value → (AttrType, normalized value)."""
    if isinstance(v, bool):
        return _A_BOOLEAN, v
    if isinstance(v, (int, np.integer)):
        iv = int(v)
        if -(1 << 31) <= iv < (1 << 31):
            return _A_INT, iv
        return _A_LONG, iv
    if isinstance(v, (float, np.floating)):
        return _A_FLOAT, float(v)
    if isinstance(v, str):
        return _A_STRING, v
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        items = list(v)
        if all(isinstance(x, bool) for x in items) and items:
            return _A_BOOLEANS, items
        if all(isinstance(x, (int, np.integer)) for x in items):
            items = [int(x) for x in items]
            if all(-(1 << 31) <= x < (1 << 31) for x in items):
                return _A_INTS, items
            return _A_LONGS, items
        if all(isinstance(x, (int, float, np.floating, np.integer))
               for x in items):
            return _A_FLOATS, [float(x) for x in items]
        if all(isinstance(x, str) for x in items):
            return _A_STRINGS, items
    raise ValueError("attr %r not representable in the reference "
                     "ProgramDesc schema" % (v,))


def _enc_attr(name, value):
    """OpDesc.Attr (framework.proto:45)."""
    out = bytearray()
    if name == "sub_block" and isinstance(value, (int, np.integer)):
        # control-flow block refs are BLOCK-typed in the reference
        _enc_field(out, 1, "bytes", name)
        _enc_field(out, 2, "varint", _A_BLOCK)
        _enc_field(out, 12, "varint", int(value))
        return bytes(out)
    at, v = _classify_attr(value)
    _enc_field(out, 1, "bytes", name)
    _enc_field(out, 2, "varint", at)
    if at == _A_INT:
        _enc_field(out, 3, "varint", v)
    elif at == _A_FLOAT:
        _enc_field(out, 4, "float", v)
    elif at == _A_STRING:
        _enc_field(out, 5, "bytes", v)
    elif at == _A_INTS:
        for x in v:
            _enc_field(out, 6, "varint", x)
    elif at == _A_FLOATS:
        for x in v:
            _enc_field(out, 7, "float", x)
    elif at == _A_STRINGS:
        for x in v:
            _enc_field(out, 8, "bytes", x)
    elif at == _A_BOOLEAN:
        _enc_field(out, 10, "varint", int(v))
    elif at == _A_BOOLEANS:
        for x in v:
            _enc_field(out, 11, "varint", int(x))
    elif at == _A_LONG:
        _enc_field(out, 13, "varint", v)
    elif at == _A_LONGS:
        for x in v:
            _enc_field(out, 15, "varint", x)
    return bytes(out)


def _dec_attr(buf):
    name, at = None, None
    i = f = s = b = l = block_idx = None
    ints, floats, strings, bools, blocks_idx, longs = [], [], [], [], [], []
    for field, wt, v in _dec_fields(buf):
        if field == 1:
            name = bytes(v).decode()
        elif field == 2:
            at = v
        elif field == 3:
            i = _signed(v, 32)
        elif field == 4:
            f = _f32(v)
        elif field == 5:
            s = bytes(v).decode()
        elif field == 6:
            ints.append(_signed(v, 32)) if wt == _WT_VARINT else \
                ints.extend(_unpack_varints(v, 32))
        elif field == 7:
            floats.append(_f32(v)) if wt == _WT_32BIT else \
                floats.extend(_unpack_f32s(v))
        elif field == 8:
            strings.append(bytes(v).decode())
        elif field == 10:
            b = bool(v)
        elif field == 11:
            bools.append(bool(v)) if wt == _WT_VARINT else \
                bools.extend(bool(x) for x in _unpack_varints(v, 32))
        elif field == 12:
            block_idx = _signed(v, 32)
        elif field == 13:
            l = _signed(v)
        elif field == 14:
            blocks_idx.append(_signed(v, 32)) if wt == _WT_VARINT else \
                blocks_idx.extend(_unpack_varints(v, 32))
        elif field == 15:
            longs.append(_signed(v)) if wt == _WT_VARINT else \
                longs.extend(_unpack_varints(v, 64))
    value = {_A_INT: i, _A_FLOAT: f, _A_STRING: s, _A_INTS: ints,
             _A_FLOATS: floats, _A_STRINGS: strings, _A_BOOLEAN: b,
             _A_BOOLEANS: bools, _A_BLOCK: block_idx, _A_LONG: l,
             _A_BLOCKS: blocks_idx, _A_LONGS: longs}.get(at)
    return name, value


def _unpack_varints(buf, bits):
    vals, pos = [], 0
    while pos < len(buf):
        v, pos = _dec_varint(buf, pos)
        vals.append(_signed(v, bits))
    return vals


def _unpack_f32s(buf):
    return [struct.unpack("<f", bytes(buf[i:i + 4]))[0]
            for i in range(0, len(buf), 4)]


# -------------------------------------------------------- var type codec

def _enc_tensor_desc(dtype, dims):
    """VarType.TensorDesc (framework.proto:139)."""
    out = bytearray()
    vt = _DTYPE_VT.get(str(dtype))
    if vt is None:
        # silently writing e.g. bfloat16 raw bytes under an FP32 tag would
        # corrupt the stream (wrong itemsize) — the reference wire format
        # simply has no code for these dtypes
        raise ValueError(
            "dtype %r has no reference VarType code — cast to one of %s "
            "before export" % (str(dtype), sorted(_DTYPE_VT)))
    _enc_field(out, 1, "varint", vt)
    for d in dims:
        _enc_field(out, 2, "varint", -1 if d is None else int(d))
    return bytes(out)


def _dec_tensor_desc(buf):
    dtype, dims = "float32", []
    for field, wt, v in _dec_fields(buf):
        if field == 1:
            dtype = _VT_DTYPE.get(v, "float32")
        elif field == 2:
            dims.append(_signed(v)) if wt == _WT_VARINT else \
                dims.extend(_unpack_varints(v, 64))
    return dtype, dims


def _enc_var_type(var):
    """VarType (framework.proto:105): type tag + nested tensor desc."""
    out = bytearray()
    vt = _VT_BY_NAME.get(getattr(var, "type", None) or "tensor",
                         _VT_LOD_TENSOR)
    _enc_field(out, 1, "varint", vt)
    dims = list(var.shape) if var.shape else []
    td = _enc_tensor_desc(var.dtype, dims)
    if vt == _VT_SELECTED_ROWS:
        _enc_bytes(out, 2, td)
    elif vt in (_VT_LOD_TENSOR, _VT_FEED_MINIBATCH, _VT_FETCH_LIST):
        inner = bytearray()
        _enc_bytes(inner, 1, td)
        lod = getattr(var, "lod_level", 0) or 0
        if lod:
            _enc_field(inner, 2, "varint", lod)
        _enc_bytes(out, 3, bytes(inner))
    elif vt == _VT_LOD_TENSOR_ARRAY:
        inner = bytearray()
        _enc_bytes(inner, 1, td)
        _enc_bytes(out, 4, bytes(inner))
    return bytes(out)


def _dec_var_type(buf):
    vt, dtype, dims, lod = _VT_RAW, "float32", None, 0
    for field, wt, v in _dec_fields(buf):
        if field == 1:
            vt = v
        elif field == 2:                       # selected_rows TensorDesc
            dtype, dims = _dec_tensor_desc(v)
        elif field in (3, 4):                  # LoDTensor(Array)Desc
            for f2, _, v2 in _dec_fields(v):
                if f2 == 1:
                    dtype, dims = _dec_tensor_desc(v2)
                elif f2 == 2:
                    lod = v2
    return vt, dtype, dims, lod


# ------------------------------------------------------------- var / op

def _enc_var_desc(var):
    """VarDesc (framework.proto:165)."""
    out = bytearray()
    _enc_field(out, 1, "bytes", var.name)
    _enc_bytes(out, 2, _enc_var_type(var))
    if var.persistable:
        _enc_field(out, 3, "varint", 1)
    return bytes(out)


def _enc_op_desc(op):
    """OpDesc (framework.proto:43); Var sub-messages are (parameter,
    arguments) pairs."""
    out = bytearray()
    for slot, names in sorted(op.inputs.items()):
        sub = bytearray()
        _enc_field(sub, 1, "bytes", slot)
        for n in names:
            _enc_field(sub, 2, "bytes", n)
        _enc_bytes(out, 1, bytes(sub))
    for slot, names in sorted(op.outputs.items()):
        sub = bytearray()
        _enc_field(sub, 1, "bytes", slot)
        for n in names:
            _enc_field(sub, 2, "bytes", n)
        _enc_bytes(out, 2, bytes(sub))
    _enc_field(out, 3, "bytes", op.type)
    for name in sorted(op.attrs):
        value = op.attrs[name]
        if value is None:
            continue
        try:
            _enc_bytes(out, 4, _enc_attr(name, value))
        except ValueError:
            continue                   # internal-only attr (e.g. callables)
    return bytes(out)


def _dec_op_desc(buf):
    inputs, outputs, attrs, op_type = {}, {}, {}, None
    for field, wt, v in _dec_fields(buf):
        if field in (1, 2):
            slot, names = None, []
            for f2, _, v2 in _dec_fields(v):
                if f2 == 1:
                    slot = bytes(v2).decode()
                elif f2 == 2:
                    names.append(bytes(v2).decode())
            (inputs if field == 1 else outputs)[slot] = names
        elif field == 3:
            op_type = bytes(v).decode()
        elif field == 4:
            name, value = _dec_attr(v)
            attrs[name] = value
    return op_type, inputs, outputs, attrs


# ------------------------------------------------------------- program

def serialize_program(program):
    """Program → reference ``ProgramDesc`` wire bytes
    (framework.proto:184)."""
    out = bytearray()
    for b in program.blocks:
        blk = bytearray()
        _enc_field(blk, 1, "varint", b.idx)
        # root block's parent is kNoneBlockIndex (-1), as the reference
        # writes (program_desc.cc:48); writing 0 would make block 0 its
        # own parent on the reference side and break parent-chain walks
        _enc_field(blk, 2, "varint", b.parent_idx)
        for var in b.vars.values():
            _enc_bytes(blk, 3, _enc_var_desc(var))
        for op in b.ops:
            _enc_bytes(blk, 4, _enc_op_desc(op))
        _enc_bytes(out, 1, bytes(blk))
    ver = bytearray()
    _enc_field(ver, 1, "varint", 0)
    _enc_bytes(out, 2, bytes(ver))
    return bytes(out)


def parse_program(data):
    """Reference ``ProgramDesc`` wire bytes → Program."""
    data = memoryview(bytes(data))
    raw_blocks = []
    for field, wt, v in _dec_fields(data):
        if field == 1:
            raw_blocks.append(v)
    prog = Program()
    # materialize blocks first so sub-block attrs can refer to any idx
    while len(prog.blocks) < len(raw_blocks):
        parent = prog.blocks[0]
        prog.blocks.append(framework.Block(prog, len(prog.blocks),
                                           parent.idx))
    for raw in raw_blocks:
        idx, parent_idx, vars_, ops = 0, -1, [], []
        for field, wt, v in _dec_fields(raw):
            if field == 1:
                idx = _signed(v, 32)
            elif field == 2:
                parent_idx = _signed(v, 32)
            elif field == 3:
                vars_.append(v)
            elif field == 4:
                ops.append(v)
        block = prog.blocks[idx]
        block.parent_idx = parent_idx if idx != 0 else -1
        for vb in vars_:
            name, vtype_buf, persistable = None, None, False
            for f2, _, v2 in _dec_fields(vb):
                if f2 == 1:
                    name = bytes(v2).decode()
                elif f2 == 2:
                    vtype_buf = v2
                elif f2 == 3:
                    persistable = bool(v2)
            vt, dtype, dims, lod = _dec_var_type(vtype_buf)
            shape = tuple(dims) if dims else None
            if persistable and vt == _VT_LOD_TENSOR and shape is not None:
                try:
                    v = Parameter(block, shape=shape, dtype=dtype, name=name)
                except ValueError:      # dynamic dim → plain persistable var
                    v = framework.Variable(block, name=name, shape=shape,
                                           dtype=dtype, persistable=True)
            else:
                v = framework.Variable(
                    block, name=name, shape=shape, dtype=dtype,
                    persistable=persistable, lod_level=lod or 0,
                    type=_NAME_BY_VT.get(vt, framework.VariableType
                                         .LOD_TENSOR))
            block.vars[name] = v
        for ob in ops:
            op_type, inputs, outputs, attrs = _dec_op_desc(ob)
            op = framework.Operator(block, op_type)
            op.inputs = inputs
            op.outputs = outputs
            op.attrs = attrs
            block.ops.append(op)
    prog._bump_version()
    return prog


# ------------------------------------------- LoDTensor parameter streams

def write_lod_tensor(stream, array):
    """Reference LoDTensor stream (lod_tensor.cc:222 SerializeToStream):
    u32 version, u64 lod-level count (+levels), then TensorToStream
    (tensor_util.cc:379): u32 version, i32 desc size, TensorDesc proto,
    raw data."""
    array = np.ascontiguousarray(array)
    stream.write(struct.pack("<I", 0))           # LoDTensor version
    stream.write(struct.pack("<Q", 0))           # lod levels (dense: none)
    stream.write(struct.pack("<I", 0))           # tensor version
    desc = _enc_tensor_desc(host_dtype_name(array.dtype), array.shape)
    stream.write(struct.pack("<i", len(desc)))
    stream.write(desc)
    stream.write(array.tobytes())


def read_lod_tensor(stream):
    """Inverse of write_lod_tensor; returns (array, lod_levels).  A
    bfloat16 tensor comes back as its payload (``V2``)."""
    (ver,) = struct.unpack("<I", stream.read(4))
    if ver != 0:
        raise ValueError("unsupported LoDTensor version %d" % ver)
    (n_lod,) = struct.unpack("<Q", stream.read(8))
    lod = []
    for _ in range(n_lod):
        (nbytes,) = struct.unpack("<Q", stream.read(8))
        lod.append(np.frombuffer(stream.read(nbytes), np.uint64))
    (tver,) = struct.unpack("<I", stream.read(4))
    if tver != 0:
        raise ValueError("unsupported Tensor version %d" % tver)
    (dlen,) = struct.unpack("<i", stream.read(4))
    dtype, dims = _dec_tensor_desc(memoryview(stream.read(dlen)))
    dt = host_np_dtype(dtype)             # bfloat16: its bits, as V2
    count = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(stream.read(count * dt.itemsize), dt).reshape(dims)
    return arr, lod


def write_combined(stream, arrays):
    """save_combine_op layout: LoDTensor streams back to back."""
    for a in arrays:
        write_lod_tensor(stream, a)


def read_combined(stream, count):
    out = []
    for _ in range(count):
        arr, _ = read_lod_tensor(stream)
        out.append(arr)
    return out


def looks_like_program_desc(data):
    """Cheap sniff: the pre-r2 pickle ``__model__`` starts with the pickle
    protocol-2+ header 0x80; ProgramDesc wire bytes start with the blocks
    tag (field 1, LEN => 0x0A)."""
    return len(data) > 0 and data[:1] == b"\x0a"
