"""DeepFM CTR (counterpart paddle_tpu/models/deepfm.py; BASELINE.json
config 5, "DeepFM CTR (sparse embedding + parameter server)"), with the
same ops and names as the JAX package.

Reference shape: python/paddle/fluid/tests/unittests/dist_ctr.py and the
ctr_dnn models.  DeepFM = a first-order linear term over the sparse
features + FM second-order interactions + a DNN tower, sharing one
embedding table.

The tables are dense, as in the JAX package: ``is_sparse=True`` is only
an attribute, each lookup's gradient is a dense scatter-add into a
zero table (``F.embedding``'s backward), and the optimizer updates every
row each step.  No hand-written kernel runs on this path.
"""

from .. import fluid


class DeepFMConfig:
    def __init__(self, num_fields=26, sparse_feature_dim=1000001,
                 embedding_size=10, dense_dim=13, layer_sizes=(400, 400, 400)):
        self.num_fields = num_fields
        self.sparse_feature_dim = sparse_feature_dim
        self.embedding_size = embedding_size
        self.dense_dim = dense_dim
        self.layer_sizes = tuple(layer_sizes)


def base_config(**kw):
    return DeepFMConfig(**kw)


def tiny_config(**kw):
    kw.setdefault("num_fields", 8)
    kw.setdefault("sparse_feature_dim", 1000)
    kw.setdefault("embedding_size", 8)
    kw.setdefault("dense_dim", 4)
    kw.setdefault("layer_sizes", (32, 32))
    return DeepFMConfig(**kw)


def deepfm(sparse_ids, dense_value, label, cfg):
    """``sparse_ids`` int64 [B, F, 1]; ``dense_value`` float [B, dense_dim].

    Returns (avg_loss, predict).
    """
    F, E = cfg.num_fields, cfg.embedding_size

    init = fluid.initializer.Uniform(-1.0 / E ** 0.5, 1.0 / E ** 0.5)
    # first-order weights: one scalar weight per sparse id
    w1 = fluid.layers.embedding(
        fluid.layers.reshape(sparse_ids, [-1, 1]),
        size=[cfg.sparse_feature_dim, 1], is_sparse=True,
        param_attr=fluid.ParamAttr(name="fm_w1", initializer=init))
    first_order = fluid.layers.reduce_sum(
        fluid.layers.reshape(w1, [-1, F, 1]), dim=1)          # [B, 1]

    # shared second-order / deep embedding table
    emb = fluid.layers.embedding(
        fluid.layers.reshape(sparse_ids, [-1, 1]),
        size=[cfg.sparse_feature_dim, E], is_sparse=True,
        param_attr=fluid.ParamAttr(name="fm_emb", initializer=init))
    emb = fluid.layers.reshape(emb, [-1, F, E])               # [B, F, E]

    # FM: 0.5 * ((sum_f e)^2 - sum_f e^2), summed over E
    sum_emb = fluid.layers.reduce_sum(emb, dim=1)             # [B, E]
    sum_sq = fluid.layers.square(sum_emb)
    sq_sum = fluid.layers.reduce_sum(fluid.layers.square(emb), dim=1)
    second_order = fluid.layers.scale(
        fluid.layers.reduce_sum(sum_sq - sq_sum, dim=1, keep_dim=True), 0.5)

    # DNN tower over [flattened embeddings ; dense features]
    deep = fluid.layers.concat(
        [fluid.layers.reshape(emb, [-1, F * E]), dense_value], axis=1)
    for width in cfg.layer_sizes:
        deep = fluid.layers.fc(
            deep, width, act="relu",
            param_attr=fluid.ParamAttr(
                initializer=fluid.initializer.Normal(
                    scale=1.0 / width ** 0.5)))
    deep_out = fluid.layers.fc(deep, 1)

    logit = first_order + second_order + deep_out
    predict = fluid.layers.sigmoid(logit)
    loss = fluid.layers.sigmoid_cross_entropy_with_logits(
        logit, fluid.layers.cast(label, "float32"))
    avg_loss = fluid.layers.mean(loss)
    return avg_loss, predict


def build_train(cfg=None, lr=1e-3):
    cfg = cfg or base_config()
    sparse_ids = fluid.layers.data(name="sparse_ids",
                                   shape=[cfg.num_fields, 1], dtype="int64")
    dense_value = fluid.layers.data(name="dense_value",
                                    shape=[cfg.dense_dim], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    avg_loss, predict = deepfm(sparse_ids, dense_value, label, cfg)
    opt = fluid.optimizer.AdamOptimizer(learning_rate=lr)
    opt.minimize(avg_loss)
    return {"loss": avg_loss, "predict": predict, "optimizer": opt,
            "config": cfg}
