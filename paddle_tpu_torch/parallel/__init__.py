"""Tensor, sequence and expert parallelism (counterpart
``paddle_tpu/parallel``).

The JAX package treats all three as first-class tiers and runs them as
annotations that GSPMD partitions over a ``(dp, mp|sp|ep)`` mesh.  The
port runs one process per rank (``fluid/distributed.py``), so each tier
is explicit per-rank execution over ``torch.distributed`` process groups
(``fluid/mesh_utils.py``: an mp/sp/ep group of ``degree`` consecutive
ranks, a dp group across them):

* **TP**: ``fluid.transpiler.TensorParallelTranspiler`` or fleet
  ``DistributedStrategy(mp_degree=N)`` — Megatron's column/row pairs as
  the autograd rules of :mod:`.tensor_parallel`; a rank holds its shard
  of each paired weight and of its optimizer state.
* **SP**: ``fluid.transpiler.SequenceParallelTranspiler`` or
  ``DistributedStrategy(sp_degree=N, sp_mode='ring'|'ulysses')`` —
  sequence feeds are sliced on their sequence dim, row-wise ops run on
  the rank's shard, and ``fused_attention`` runs the ring or Ulysses of
  :mod:`.sequence_parallel` (K2–K4 per block).
* **EP**: ``fluid.layers.switch_moe`` and
  ``fluid.transpiler.ExpertParallelTranspiler`` or
  ``DistributedStrategy(ep_degree=N)`` — a rank holds ``E/ep`` experts;
  dense dispatch or the GShard all-to-all island of
  :mod:`.expert_parallel`.

The program-level rules that place these primitives (which ops run on
shards, what is gathered, sliced or summed) are
``fluid/model_parallel.py``.
"""

from .expert_parallel import (all_to_all, aux_load_balance_loss,  # noqa
                              route_tokens, switch_moe, switch_moe_dense,
                              switch_moe_sharded)
from .sequence_parallel import (local_attention, ring_attention,  # noqa
                                ulysses_attention)
from .tensor_parallel import (column_parallel_matmul, copy_to,  # noqa
                              fc_column_parallel, fc_row_parallel,
                              gather_from, mlp_block, reduce_from,
                              row_parallel_matmul, scatter_to,
                              vocab_parallel_embedding)
