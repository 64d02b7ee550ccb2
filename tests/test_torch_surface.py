"""The public surface of the port (paddle_tpu_torch) against paddle_tpu's:
every public name of JAX ``fluid`` and ``fluid.layers``, and every op
type JAX registers that is not a ``_grad`` type, either resolves in the
port or stands in the set below of what is still to come, grouped by the
ROADMAP item that will port it.  A name lost from the port fails the
test, and so does a name ported without being taken out of its set: the
sets shrink as the items land.

A few public names of JAX ``fluid.layers`` are its modules' own imports
leaking through ``from .nn import *`` (no ``__all__`` there); they are
not layers and are excluded by name, each with its reason.  The test
also holds that the names the step-0 repairs export build the JAX
package's ops.
"""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import registry as jregistry

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import registry

# imports of the JAX layer modules that star-imports leak into the
# namespace; none is a layer
LEAKED_IMPORTS = {
    "np": "numpy, imported by layers/nn.py and tensor.py",
    "tensor_layers": "layers/nn.py's alias of layers/tensor.py",
    "LayerHelper": "the layer builder's helper class (fluid.layer_helper)",
    "Variable": "the framework's class (fluid.framework.Variable)",
    "canonical_dtype": "a dtype helper of fluid.data_types",
    "ConstantInitializer": "an initializer class (fluid.initializer)",
    "NormalInitializer": "an initializer class (fluid.initializer)",
    "XavierInitializer": "an initializer class (fluid.initializer)",
}

# fluid.layers names still to port, by ROADMAP item
LAYERS_TO_PORT = {
    "13c.3b-ii": {
        "adaptive_pool2d", "adaptive_pool3d", "affine_grid", "data_norm",
        "gaussian_random_batch_size_like", "get_tensor_from_selected_rows",
        "hash", "lod_reset", "merge_selected_rows", "multiplex",
        "random_crop", "rank", "reduce_all", "reduce_any",
        "sampled_softmax_with_cross_entropy", "similarity_focus", "unique",
    },
    "13c.3c": {"py_func", "fsp_matrix", "tree_conv"},
    "13c.6": {"device"},
    "13c.7": {"Preprocessor", "batch", "load", "open_files",
              "random_data_generator", "shuffle"},
}

# top-level fluid names still to port (or with no port meaning)
FLUID_TO_PORT = {
    "13c.5": {"dygraph", "in_dygraph_mode"},
    "13c.6": {"WeightedAverage", "average", "debugger", "install_check",
              "log_helper"},
    "not a port name": {"TPUPlace", "aot", "core_shim"},
}

# op types still to port, by ROADMAP item
OPS_TO_PORT = {
    "13c.3b-ii": {
        # misc_ops3.py (its quantize ops go with 13c.4)
        "conv_shift", "fc", "fill", "lod_reset", "max_pool2d_with_index",
        "spp", "unpool",
        # misc_ops4.py
        "adaptive_pool2d", "adaptive_pool3d", "affine_grid", "data_norm",
        "gaussian_random_batch_size_like", "get_tensor_from_selected_rows",
        "hash", "merge_selected_rows", "multiplex", "random_crop", "rank",
        "reduce_all", "reduce_any",
        # misc_ops5.py
        "cross_entropy2", "delete_var", "fake_init", "fill_zeros_like2",
        "max_pool3d_with_index", "positive_negative_pair",
        "precision_recall", "sample_logits", "similarity_focus", "unique",
    },
    "13c.3c": {
        # fusion_ops.py
        "alloc_continuous_space", "attention_lstm", "conv2d_fusion", "dgc",
        "dgc_clip_by_norm", "fused_elemwise_activation",
        "fused_embedding_fc_lstm", "fused_embedding_seq_pool", "fusion_gru",
        "fusion_lstm", "fusion_repeated_fc_relu",
        "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc",
        "fusion_seqpool_concat", "fusion_squared_mat_sub",
        "fusion_transpose_flatten_concat", "gen_nccl_id", "tree_conv",
        "conditional_block_infer", "py_func",
        # compat_ops.py
        "read", "create_custom_reader", "get_places", "fsp",
    },
    "13c.4": {
        "fake_channel_wise_dequantize_max_abs",
        "fake_channel_wise_quantize_abs_max",
        "fake_channel_wise_quantize_dequantize_abs_max",
        "fake_dequantize_max_abs", "fake_quantize_abs_max",
        "fake_quantize_dequantize_abs_max",
        "fake_quantize_dequantize_moving_average_abs_max",
        "fake_quantize_moving_average_abs_max",
        "fake_quantize_range_abs_max", "quantized_conv2d",
        "quantized_matmul", "quantize", "dequantize", "requantize",
        "moving_average_abs_max_scale",
    },
}


def _public(module):
    return {n for n in dir(module) if not n.startswith("_")}


def _union(groups):
    out = set()
    for names in groups.values():
        assert not out & names, sorted(out & names)
        out |= names
    return out


def _non_grad(defs):
    return {t for t in defs if not t.endswith("_grad")}


@pytest.mark.parametrize("surface", ["layers", "fluid", "op types"])
def test_missing_names_are_the_listed_ones(surface):
    """What JAX has and the port lacks equals the listed set exactly:
    35 ``fluid.layers`` names (27 layers and the 8 leaked imports), 10
    ``fluid`` names, 69 op types."""
    if surface == "layers":
        want, count = _union(LAYERS_TO_PORT) | set(LEAKED_IMPORTS), 35
        missing = _public(jfluid.layers) - _public(fluid.layers)
    elif surface == "fluid":
        want, count = _union(FLUID_TO_PORT), 10
        missing = _public(jfluid) - _public(fluid)
    else:
        want, count = _union(OPS_TO_PORT), 69
        missing = _non_grad(jregistry.OP_DEFS) - _non_grad(
            registry.OP_DEFS)
    assert len(want) == count
    assert sorted(missing - want) == [], "lost from the port"
    assert sorted(want - missing) == [], "ported: take out of the set"


def test_counts():
    """324 op types of JAX's 393 (the 49 of ``misc_ops.py`` and
    ``misc_ops2.py`` in item 13c.3b on top of 275: the core types of item
    13c.3a and ``fill_any_like``, behind ``layers.ones_like``, on top of
    240); none is the port's own."""
    mine, jax = _non_grad(registry.OP_DEFS), _non_grad(jregistry.OP_DEFS)
    assert (len(mine), len(jax)) == (324, 393)
    assert mine <= jax


def test_port_only_layer_names():
    """The port's one layer name JAX lacks: ``BlockGuard``, the base of
    its control-flow guards."""
    assert _public(fluid.layers) - _public(jfluid.layers) == {"BlockGuard"}


def _ops_of(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        build(pkg)
    return ([(op.type, sorted(op.attrs.items())) for op in
             main.global_block().ops],
            [op.type for op in startup.global_block().ops])


def _build_repaired(pkg):
    L = pkg.layers
    x = L.data("x", [4, 6], dtype="float32", append_batch_size=False)
    y = L.data("y", [6, 3], dtype="float32", append_batch_size=False)
    L.mul(x, y)
    L.gelu(x)
    L.gelu(x, approximate=True)
    t = L.create_tensor("float32", name="t")
    L.assign(x, t)
    L.create_global_var([2], 0.5, "float32", persistable=True, name="g")
    arr = L.create_array("float32")
    L.array_write(x, L.fill_constant([1], "int64", 0), array=arr)
    L.tensor_array_to_tensor(arr, axis=0)
    L.fc(x, 2, param_attr=pkg.ParamAttr(initializer=pkg.MSRA()))


def test_repaired_names_build_the_jax_ops():
    """``layers.mul``, ``gelu`` (with ``approximate``), ``create_tensor``,
    ``create_global_var``, ``tensor_array_to_tensor`` and ``fluid.MSRA``
    resolve and build the ops (types and attributes) the JAX package
    builds, in the main and the startup program."""
    assert _ops_of(fluid, _build_repaired) == _ops_of(jfluid,
                                                      _build_repaired)


def test_repaired_names_run_as_jax():
    """The repaired layers' program runs in both packages to the same
    values (``mul``, both ``gelu`` forms, the joined array)."""
    from test_torch_book_ops import _both

    rng = np.random.RandomState(0)
    xv = rng.randn(4, 6).astype(np.float32)
    yv = rng.randn(6, 3).astype(np.float32)

    def build(pkg):
        L = pkg.layers
        x = L.data("x", [4, 6], dtype="float32", append_batch_size=False)
        y = L.data("y", [6, 3], dtype="float32", append_batch_size=False)
        arr = L.create_array("float32")
        L.array_write(x, L.fill_constant([1], "int64", 0), array=arr)
        L.array_write(L.scale(x, 2.0), L.fill_constant([1], "int64", 1),
                      array=arr)
        joined, sizes = L.tensor_array_to_tensor(arr, axis=0)
        return [L.mul(x, y), L.gelu(x), L.gelu(x, approximate=True),
                joined, sizes]

    out, _ = _both(build, {"x": xv, "y": yv})
    np.testing.assert_allclose(out[0], xv @ yv, rtol=1e-5, atol=1e-5)


def test_top_level_additions():
    """``fluid.grad_var_name``, ``cuda_pinned_places`` (CPU places, as
    in JAX) and ``WeightNormParamAttr`` (a ParamAttr carrying ``dim``,
    no reparametrisation in either package)."""
    assert fluid.grad_var_name("w") == jfluid.grad_var_name("w") == "w@GRAD"
    assert [type(p).__name__ for p in fluid.cuda_pinned_places(2)] == \
        ["CPUPlace", "CPUPlace"]
    attr = fluid.WeightNormParamAttr(dim=1, name="v")
    assert isinstance(attr, fluid.ParamAttr)
    assert (attr.dim, attr.name) == (1, "v")
