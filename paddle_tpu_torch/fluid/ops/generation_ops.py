"""Beam-search ops on static ``[B, K]`` beams (counterpart
``paddle_tpu/fluid/ops/generation_ops.py``): ``beam_search`` selects
one step's beams, ``beam_search_decode`` backtracks the stacked steps
into sentences.

A finished beam (its last id is ``end_id``) offers one candidate, itself
with its frozen score, and every other candidate of its row scores
``_NEG_INF``.  Many candidates then tie at exactly ``_NEG_INF``, and
the selection must break ties as ``lax.top_k`` does, the lower flat
index first: :func:`tensor_ops.top_k_stable`.
"""

import torch

from ..registry import register_op
from .tensor_ops import top_k_stable

_NEG_INF = -1e9


@register_op("beam_search", nondiff_inputs=("pre_ids", "pre_scores", "ids",
                                            "scores"), stop_gradient=True)
def _beam_search(ctx, op):
    """generation_ops.py:32: from ``[B, K, C]`` candidate ids and
    accumulated scores (with ``is_accumulated`` false, probabilities to
    log and add to ``pre_scores``), the ``beam_size`` best of each row's
    ``K·C``: selected_ids, selected_scores and parent_idx, ``[B, K']``."""
    pre_ids = ctx.i("pre_ids")
    pre_scores = ctx.i("pre_scores")
    cand_ids = ctx.i("ids")
    cand_scores = ctx.i("scores")
    if pre_ids.dim() == 3:
        pre_ids = pre_ids[..., 0]
    if pre_scores.dim() == 3:
        pre_scores = pre_scores[..., 0]
    beam_size = int(ctx.attr("beam_size"))
    end_id = int(ctx.attr("end_id"))
    if not ctx.attr("is_accumulated", True):
        cand_scores = torch.log(cand_scores.clamp_min(1e-30)) + \
            pre_scores[:, :, None]
    B, K, C = cand_scores.shape
    finished = (pre_ids == end_id)[:, :, None]
    slot0 = torch.zeros((1, 1, C), dtype=torch.bool,
                        device=cand_scores.device)
    slot0[..., 0] = True
    neg = torch.full_like(cand_scores, _NEG_INF)
    cand_scores = torch.where(
        finished, torch.where(slot0, pre_scores[:, :, None], neg),
        cand_scores)
    cand_ids = torch.where(finished, torch.full_like(cand_ids.long(),
                                                     end_id),
                           cand_ids.long())
    sel_scores, flat_idx = top_k_stable(cand_scores.reshape(B, K * C),
                                        beam_size)
    ctx.set("selected_ids", torch.gather(cand_ids.reshape(B, K * C), 1,
                                         flat_idx))
    ctx.set("selected_scores", sel_scores)
    ctx.set("parent_idx", flat_idx // C)


@register_op("beam_search_decode", nondiff_inputs=("Ids", "Scores",
                                                   "ParentIdx"),
             stop_gradient=True)
def _beam_search_decode(ctx, op):
    """generation_ops.py:72: walk the parent pointers of ``[T, B, K]``
    Ids/ParentIdx back from the last step: SentenceIds ``[B, K, T]``,
    every token after a sentence's first ``end_id`` read as ``end_id``,
    and SentenceScores the last step's ``[B, K]``."""
    ids = ctx.i("Ids").long()
    parents = ctx.i("ParentIdx").long()
    scores = ctx.i("Scores")
    T, B, K = ids.shape
    end_id = int(ctx.attr("end_id"))
    beam = torch.arange(K, device=ids.device)[None, :].expand(B, K)
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, beam)
        beam = torch.gather(parents[t], 1, beam)
    sentences = torch.stack(toks, dim=-1)                # [B, K, T]
    ended = torch.cumsum((sentences == end_id).int(), dim=-1)
    sentences = torch.where(ended > 1, torch.full_like(sentences, end_id),
                            sentences)
    ctx.set("SentenceIds", sentences)
    ctx.set("SentenceScores", scores[-1])
