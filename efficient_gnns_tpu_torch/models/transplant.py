"""Load flax parameters of the JAX package's models into the port's modules.

``from_jax_params`` takes the flax ``params`` and ``batch_stats`` trees as
nested dicts of NumPy arrays (e.g. ``jax.tree.map(np.asarray, params)``,
converted by the caller) and returns a ``state_dict`` for the port's model or
projection head. A flax ``Dense`` kernel is ``[in, out]``; the port keeps
that layout (its ``GCNConv.weight``, ``SAGEConv.weight`` / ``root_weight``,
``PyGGATConv.weight``, ``Dense.weight``, the projection heads' ``weight`` /
``lin_weight``, ``DGLGATConv.fc_weight`` / ``res_weight`` and
``FeedForwardNet.weights``, ``RGCNConv.rel_weights`` are applied as
``x @ weight``), so kernels are
copied, not transposed; ``attn_l`` / ``attn_r`` and ``att_src`` /
``att_dst`` keep their ``[D, H]`` layout too. ``mol_from_jax_params`` does
the same for the JAX ``MolGNN`` (``models/mol.py``), whose flax names are
its own.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_RULES = (
    # GCN (bias of the conv) and SAGE (bias of Dense_0, root weight Dense_1)
    (re.compile(r"conv_(\d+)/Dense_0/kernel"), "convs.{}.weight"),
    (re.compile(r"conv_(\d+)/bias"), "convs.{}.bias"),
    (re.compile(r"conv_(\d+)/Dense_0/bias"), "convs.{}.bias"),
    (re.compile(r"conv_(\d+)/Dense_1/kernel"), "convs.{}.root_weight"),
    # DGLGCN's bias-free parallel linears (its convs and BNs take the GCN rules)
    (re.compile(r"linear_(\d+)/kernel"), "linear_weights.{}"),
    # ProjectionLinear / ProjectionMLP
    (re.compile(r"Dense_0/kernel"), "weight"),
    (re.compile(r"Dense_0/bias"), "bias"),
    # ProjectionGCD
    (re.compile(r"conv/Dense_0/kernel"), "conv.weight"),
    (re.compile(r"conv/bias"), "conv.bias"),
    (re.compile(r"lin/kernel"), "lin_weight"),
    (re.compile(r"lin/bias"), "lin_bias"),
    (re.compile(r"MaskedBatchNorm_0/scale"), "bn.scale"),
    (re.compile(r"MaskedBatchNorm_0/bias"), "bn.bias"),
    # PPIGAT (its convs' kernel and bias take the GCN rules above)
    (re.compile(r"conv_(\d+)/att_(src|dst)"), "convs.{}.att_{}"),
    (re.compile(r"lin_(\d+)/kernel"), "lins.{}.weight"),
    (re.compile(r"lin_(\d+)/bias"), "lins.{}.bias"),
    # RGCN: per-relation kernels, per-node-type root Dense, embedding tables
    (re.compile(r"conv_(\d+)/rel_lin_(\d+)/kernel"), "convs.{}.rel_weights.{}"),
    (re.compile(r"conv_(\d+)/root_lin_(\d+)/kernel"), "convs.{}.root_lins.{}.weight"),
    (re.compile(r"conv_(\d+)/root_lin_(\d+)/bias"), "convs.{}.root_lins.{}.bias"),
    (re.compile(r"emb_(\d+)"), "embs.{}"),
    # GATTeacher
    (re.compile(r"gat_(\d+)/Dense_0/kernel"), "convs.{}.fc_weight"),
    (re.compile(r"gat_(\d+)/Dense_1/kernel"), "convs.{}.res_weight"),
    (re.compile(r"gat_(\d+)/attn_([lr])"), "convs.{}.attn_{}"),
    (re.compile(r"bias_last/bias"), "bias_last.bias"),
    # SIGN: one FeedForwardNet per hop, the shared slope, the project FFN
    (re.compile(r"inception_(\d+)/lin_(\d+)/kernel"), "inceptions.{}.weights.{}"),
    (re.compile(r"inception_(\d+)/lin_(\d+)/bias"), "inceptions.{}.biases.{}"),
    (re.compile(r"inception_(\d+)/prelu_alpha"), "inceptions.{}.prelu_alpha"),
    (re.compile(r"project/lin_(\d+)/kernel"), "project.weights.{}"),
    (re.compile(r"project/lin_(\d+)/bias"), "project.biases.{}"),
    (re.compile(r"project/prelu_alpha"), "project.prelu_alpha"),
    (re.compile(r"prelu_alpha"), "prelu_alpha"),
    # both
    (re.compile(r"bn_(\d+)/scale"), "bns.{}.scale"),
    (re.compile(r"bn_(\d+)/bias"), "bns.{}.bias"),
)
_STAT_RULES = (
    (re.compile(r"bn_(\d+)/mean"), "bns.{}.running_mean"),
    (re.compile(r"bn_(\d+)/var"), "bns.{}.running_var"),
    (re.compile(r"MaskedBatchNorm_0/mean"), "bn.running_mean"),
    (re.compile(r"MaskedBatchNorm_0/var"), "bn.running_var"),
)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = np.asarray(v)
    return flat


def _rename(flat: Dict[str, np.ndarray], rules) -> Dict[str, torch.Tensor]:
    out = {}
    for key, value in flat.items():
        for pattern, template in rules:
            m = pattern.fullmatch(key)
            if m:
                out[template.format(*m.groups())] = torch.from_numpy(
                    np.array(value, dtype=np.float32)
                )
                break
        else:
            raise KeyError(f"no port counterpart for flax variable {key!r}")
    return out


def from_jax_params(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` for the port's ``GCN``, ``SAGE``, ``DGLGCN``, ``GATTeacher``, ``SIGN``,
    ``PPIGAT``, ``RGCN`` or a projection head (``ProjectionLinear``, ``ProjectionMLP``,
    ``ProjectionGCD``) from the JAX module's ``params`` and ``batch_stats``."""
    state = _rename(_flatten(params), _PARAM_RULES)
    state.update(_rename(_flatten(batch_stats), _STAT_RULES))
    return state


_MOL_PARAM_RULES = (
    (re.compile(r"CategoricalEncoder_0/emb_(\d+)/embedding"), "atom_encoder.embs.{}"),
    (re.compile(r"bond_encoder_(\d+)/emb_(\d+)/embedding"), "bond_encoders.{}.embs.{}"),
    # GINEConv (Dense_0, Dense_1, MaskedBatchNorm_0, eps), GCNMolConv
    # (Dense_0, root_emb), PNAConv (edge_proj, pre_*, post_*, mix)
    (re.compile(r"conv_(\d+)/Dense_(\d+)/kernel"), "convs.{}.dense.{}.weight"),
    (re.compile(r"conv_(\d+)/Dense_(\d+)/bias"), "convs.{}.dense.{}.bias"),
    (re.compile(r"conv_(\d+)/MaskedBatchNorm_0/(scale|bias)"), "convs.{}.bn.{}"),
    (re.compile(r"conv_(\d+)/(edge_proj|mix)/kernel"), "convs.{}.{}.weight"),
    (re.compile(r"conv_(\d+)/(edge_proj|mix)/bias"), "convs.{}.{}.bias"),
    (re.compile(r"conv_(\d+)/(eps|root_emb|pre_w|pre_b|post_w|post_b)"), "convs.{}.{}"),
    (re.compile(r"bn_(\d+)/(scale|bias)"), "bns.{}.{}"),
    # the virtual node's MLPs: Dense_{2i}, Dense_{2i+1} after layer i
    (re.compile(r"Dense_(\d+)/kernel"), "vn_lins.{}.weight"),
    (re.compile(r"Dense_(\d+)/bias"), "vn_lins.{}.bias"),
    (re.compile(r"virtualnode_emb"), "virtualnode_emb"),
    (re.compile(r"graph_pred/kernel"), "graph_pred.weight"),
    (re.compile(r"graph_pred/bias"), "graph_pred.bias"),
)
_MOL_STAT_RULES = (
    (re.compile(r"conv_(\d+)/MaskedBatchNorm_0/mean"), "convs.{}.bn.running_mean"),
    (re.compile(r"conv_(\d+)/MaskedBatchNorm_0/var"), "convs.{}.bn.running_var"),
    (re.compile(r"bn_(\d+)/mean"), "bns.{}.running_mean"),
    (re.compile(r"bn_(\d+)/var"), "bns.{}.running_var"),
)


def mol_from_jax_params(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """``state_dict`` for the port's ``MolGNN`` (any conv, with or without
    the virtual node) from the JAX ``MolGNN``'s ``params`` and
    ``batch_stats``."""
    state = _rename(_flatten(params), _MOL_PARAM_RULES)
    state.update(_rename(_flatten(batch_stats), _MOL_STAT_RULES))
    return state
