"""The port's ProgramDesc and LoDTensor codec (paddle_tpu_torch.fluid.
proto_compat) against paddle_tpu's, on the CPU.

- The same programs built in both packages — the tiny BERT encoder (main,
  startup and its test clone), tiny BERT pretraining, ResNet-18 at 32²,
  tiny Transformer NMT, tiny DeepFM, LeNet, and the pruned inference
  export of the BERT encoder with its feed and fetch ops — serialize to
  byte-identical ``__model__`` bytes.
- Each package parses the other's bytes back to the same structure
  (blocks, vars with shape/dtype/persistable/type, ops with slots and
  attrs), and re-serializes them to the same bytes.
- LoDTensor streams and combined streams are byte-identical in both
  directions for every dtype of the wire format, bfloat16 (tag 22)
  included: the port writes and reads bf16 as its 2-byte payload, the
  JAX package through ml_dtypes.
"""

import io

import ml_dtypes
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import proto_compat as jpc
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import proto_compat as ppc
from paddle_tpu_torch.fluid.data_types import BF16_HOST
from paddle_tpu_torch.models import bert, deepfm, lenet, resnet, transformer

FEEDS = ("src_ids", "pos_ids", "sent_ids", "input_mask")


def _encoder(pkg, mod):
    cfg = mod.tiny_config()
    data = [pkg.layers.data(n, [cfg.max_seq_len, 1],
                            dtype="float32" if n == "input_mask"
                            else "int64") for n in FEEDS]
    return mod.bert_encoder(*data, cfg)


def _export(pkg, mod):
    """The BERT encoder's inference program as save_inference_model
    writes it: pruned, feed ops prepended, fetch ops appended."""
    enc = _encoder(pkg, mod)
    main = pkg.default_main_program()
    pruned = pkg.io.prune_program(main, list(FEEDS), [enc.name])
    pkg.io.prepend_feed_ops(pruned, list(FEEDS))
    pkg.io.append_fetch_ops(pruned, [enc.name])
    return pruned


BUILDERS = {
    "bert_encoder": (lambda p, m: _encoder(p, m), (jbert, bert)),
    "bert_pretrain": (lambda p, m: m.build_pretrain(
        m.tiny_config(), lr=1e-3, max_pred_per_seq=4), (jbert, bert)),
    "resnet18": (lambda p, m: m.build_train(depth=18, image_size=32,
                                            class_dim=10),
                 (jresnet, resnet)),
    "nmt": (lambda p, m: m.build_train(m.tiny_config(), lr=2.0,
                                       warmup_steps=4),
            (jtransformer, transformer)),
    "deepfm": (lambda p, m: m.build_train(m.tiny_config(), lr=1e-3),
               (jdeepfm, deepfm)),
    "lenet": (lambda p, m: m.build_train(lr=1e-3), (jlenet, lenet)),
}


def _build(pkg, mod, fn):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        fn(pkg, mod)
    return main, startup


_CACHE = {}


def programs(name):
    """{which: (jax program, port program)} of one builder."""
    if name not in _CACHE:
        fn, (jmod, pmod) = BUILDERS[name]
        jm, js = _build(jfluid, jmod, fn)
        pm, ps = _build(fluid, pmod, fn)
        _CACHE[name] = {"main": (jm, pm), "startup": (js, ps)}
        if name in ("bert_encoder", "resnet18"):
            _CACHE[name]["test"] = (jm.clone(for_test=True),
                                    pm.clone(for_test=True))
    return _CACHE[name]


CASES = [(n, w) for n in BUILDERS for w in ("main", "startup")] + \
    [("bert_encoder", "test"), ("resnet18", "test")]


@pytest.mark.parametrize("name,which", CASES,
                         ids=["%s-%s" % c for c in CASES])
def test_same_program_serializes_to_identical_bytes(name, which):
    jprog, pprog = programs(name)[which]
    jbytes = jpc.serialize_program(jprog)
    pbytes = ppc.serialize_program(pprog)
    assert len(pbytes) > 1000
    assert pbytes == jbytes
    assert pprog.serialize_to_string() == pbytes


def test_inference_export_program_serializes_to_identical_bytes():
    jprog = _build(jfluid, jbert, lambda p, m: None)[0]
    with jfluid.program_guard(jprog), jfluid.unique_name.guard():
        jexp = _export(jfluid, jbert)
    pprog = _build(fluid, bert, lambda p, m: None)[0]
    with fluid.program_guard(pprog), fluid.unique_name.guard():
        pexp = _export(fluid, bert)
    types = [op.type for op in pexp.global_block().ops]
    assert types[:4] == ["feed"] * 4 and types[-1] == "fetch"
    assert ppc.serialize_program(pexp) == jpc.serialize_program(jexp)


def _structure(prog):
    out = []
    for b in prog.blocks:
        out.append((b.idx, b.parent_idx,
                    [(n, tuple(v.shape) if v.shape else None, v.dtype,
                      bool(v.persistable), v.type,
                      type(v).__name__ == "Parameter")
                     for n, v in b.vars.items()],
                    [(op.type, op.inputs, op.outputs, op.attrs)
                     for op in b.ops]))
    return out


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_each_package_parses_the_others_bytes(name):
    jprog, pprog = programs(name)["main"]
    pbytes = ppc.serialize_program(pprog)
    jbytes = jpc.serialize_program(jprog)
    from_port_in_jax = jpc.parse_program(pbytes)
    from_jax_in_port = fluid.Program.parse_from_string(jbytes)
    assert _structure(from_jax_in_port) == _structure(from_port_in_jax)
    # and each re-serializes to the bytes it came from
    assert ppc.serialize_program(from_jax_in_port) == jbytes
    assert jpc.serialize_program(from_port_in_jax) == pbytes
    # the parsed program is a port program the executor can read
    assert isinstance(from_jax_in_port, fluid.Program)
    params = [v.name for v in from_jax_in_port.global_block()
              .all_parameters()]
    assert params and all(
        isinstance(from_jax_in_port.global_block().var(n),
                   fluid.framework.Parameter) for n in params)


DTYPES = ["bool", "int16", "int32", "int64", "float16", "float32",
          "float64", "uint8", "int8", "bfloat16"]


def _arrays(dtype, seed):
    """(JAX host array, port host array) holding the same bits."""
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 5, 2) * 50
    if dtype == "bool":
        a = x > 0
    elif dtype == "bfloat16":
        a = x.astype(ml_dtypes.bfloat16)
        return a, a.view(np.int16).view(BF16_HOST)
    else:
        a = x.astype(dtype)
    return a, a.copy()


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).tobytes(), a.shape


@pytest.mark.parametrize("dtype", DTYPES)
def test_lod_tensor_stream_bytes_match_both_ways(dtype):
    ja, pa = _arrays(dtype, seed=DTYPES.index(dtype))
    jbuf, pbuf = io.BytesIO(), io.BytesIO()
    jpc.write_lod_tensor(jbuf, ja)
    ppc.write_lod_tensor(pbuf, pa)
    assert pbuf.getvalue() == jbuf.getvalue()
    got, lod = ppc.read_lod_tensor(io.BytesIO(jbuf.getvalue()))
    assert lod == []
    assert _bits(got) == _bits(ja)
    if dtype == "bfloat16":
        assert got.dtype == BF16_HOST
    else:
        assert got.dtype == ja.dtype
    back, _ = jpc.read_lod_tensor(io.BytesIO(pbuf.getvalue()))
    assert back.dtype == ja.dtype and _bits(back) == _bits(ja)


def test_combined_streams_match_both_ways():
    pairs = [_arrays(dt, seed=i) for i, dt in enumerate(DTYPES)]
    jbuf, pbuf = io.BytesIO(), io.BytesIO()
    jpc.write_combined(jbuf, [j for j, _ in pairs])
    ppc.write_combined(pbuf, [p for _, p in pairs])
    assert pbuf.getvalue() == jbuf.getvalue()
    got = ppc.read_combined(io.BytesIO(jbuf.getvalue()), len(pairs))
    back = jpc.read_combined(io.BytesIO(pbuf.getvalue()), len(pairs))
    for (ja, _), g, b in zip(pairs, got, back):
        assert _bits(g) == _bits(ja) and _bits(b) == _bits(ja)


def test_program_desc_sniff_and_unknown_dtype():
    pprog = programs("lenet")["main"][1]
    data = pprog.serialize_to_string()
    assert ppc.looks_like_program_desc(data)
    assert not ppc.looks_like_program_desc(b"\x80\x04pickle")
    with pytest.raises(ValueError, match="no reference VarType code"):
        ppc.write_lod_tensor(io.BytesIO(), np.zeros(3, np.uint32))
