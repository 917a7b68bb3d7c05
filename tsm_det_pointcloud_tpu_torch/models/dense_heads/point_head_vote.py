"""TSM vote head with transferable class statistics, eval path.

Counterpart of tsm_det_pointcloud_tpu/models/dense_heads/point_head_vote.py:
`VoteHeadBranch` on the student route (plain REG_FC regression, statistics
given) and `PointHeadVoteSASAStatisticDistillation` with its three
`statistics` buffers. Training, target assignment and losses, and the
teacher branch are not ported.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops.box_coder_utils import PointBinResidualCoder
from ..backbones_3d.pointnet2_modules import BatchNorm, SharedMLP
from ..backbones_3d.voxel_pointnet2_backbone import VoxelSAModule, factored_grid


class VoteHeadBranch(nn.Module):
    """One vote-head branch: votes, VSA aggregation over the backbone's
    centroid sparse tensor, statistic-conditioned cls and a plain REG_FC
    regression. in_channels: point feature channels; sp_channels: the
    sparse tensor's feature channels."""

    def __init__(self, model_cfg, vote_cfg, vsa_cfg, num_class, box_coder,
                 in_channels, sp_channels, gated_reg=False):
        super().__init__()
        if gated_reg:
            raise NotImplementedError(
                "the statistic-gated regression (teacher branch) is not ported")
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_class = num_class
        self.box_coder = box_coder
        self.sample_range = tuple(cfg["SAMPLE_RANGE"])
        self.vote_fc = SharedMLP(in_channels, list(vote_cfg["VOTE_FC"]))
        self.vote_out = nn.Linear(int(vote_cfg["VOTE_FC"][-1]), 3)
        self.register_buffer(
            "max_translation",
            torch.tensor(vote_cfg["MAX_TRANSLATION_RANGE"], dtype=torch.float32),
            persistent=False)
        vs = (np.asarray(cfg["VOXEL_CONFIG"]["VOXEL_SIZE"], np.float64)
              * float(vsa_cfg.get("SPARSE_TENSOR_STRIDE", 4)))
        pcr = tuple(cfg["VOXEL_CONFIG"]["POINT_CLOUD_RANGE"])
        self.vsa = VoxelSAModule(
            sa_layer_idx=6,
            radii=[float(r) for r in vsa_cfg["RADIUS"]],
            nsamples=[int(n) for n in vsa_cfg["NSAMPLE"]],
            mlps=[list(m) for m in vsa_cfg["MLPS"]],
            query_ranges=[list(q) for q in vsa_cfg["QUERY_RANGE"]],
            dilated_group=bool(vsa_cfg.get("DILATED_RADIUS_GROUP", False)),
            aggregation_mlp=None, confidence_mlp=None, num_class=num_class,
            voxel_size=tuple(vs), point_cloud_range=pcr,
            grid=factored_grid(pcr, vs), sp_in_channels=sp_channels,
        )
        self.shared_fc = SharedMLP(self.vsa.out_channels, list(cfg["SHARED_FC"]))
        C = int(cfg["SHARED_FC"][-1])
        for i in range(num_class):
            setattr(self, f"cls{i}_fc", nn.Linear(C, 64, bias=False))
            setattr(self, f"cls{i}_bn", BatchNorm(64, eps=1e-3))
            setattr(self, f"cls{i}_out", nn.Linear(64, 1))
        self.reg_fc = SharedMLP(C, list(cfg["REG_FC"]))
        self.reg_out = nn.Linear(int(cfg["REG_FC"][-1]), box_coder.code_size)

    def forward(self, point_coords, point_features, point_valid, sp,
                centroid_xyz, statistics):
        lo, hi = self.sample_range
        cand_xyz = point_coords[:, lo:hi]
        cand_feat = point_features[:, lo:hi]
        cand_valid = point_valid[:, lo:hi]

        offsets = self.vote_out(self.vote_fc(cand_feat))
        rng = self.max_translation
        offsets = torch.maximum(torch.minimum(offsets, rng), -rng)
        vote_xyz = cand_xyz + offsets

        feats = self.vsa(vote_xyz, None, cand_valid, sp=sp,
                         centroid_xyz=centroid_xyz, new_xyz=vote_xyz)["new_features"]
        shared = self.shared_fc(feats)

        cls_list = []
        for i in range(self.num_class):
            cond = shared * statistics[i][None, None, :]
            h = torch.relu(getattr(self, f"cls{i}_bn")(getattr(self, f"cls{i}_fc")(cond)))
            cls_list.append(getattr(self, f"cls{i}_out")(h))
        cls_preds = torch.cat(cls_list, -1)

        reg_preds = self.reg_out(self.reg_fc(shared))
        box_preds = self.box_coder.decode(reg_preds, vote_xyz)
        return dict(candidate_xyz=cand_xyz, candidate_valid=cand_valid,
                    vote_xyz=vote_xyz, cls_preds=cls_preds, reg_preds=reg_preds,
                    box_preds=box_preds, shared=shared)


class PointHeadVoteSASAStatisticDistillation(nn.Module):
    """Distillation head, eval path: the student branch `s_head` with the
    shared statistics buffers (transferred from the teacher checkpoint)."""

    def __init__(self, model_cfg, num_class, input_channels, meta=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        tc = model_cfg["TARGET_CONFIG"]
        self.box_coder = PointBinResidualCoder(**dict(tc.get("BOX_CODER_CONFIG", {})))
        self.s_head = VoteHeadBranch(
            model_cfg, dict(model_cfg["S_VOTE_CONFIG"]),
            dict(model_cfg["S_VSA_CONFIG"]), num_class, self.box_coder,
            in_channels=input_channels, sp_channels=input_channels)
        C = int(model_cfg["SHARED_FC"][-1])
        for name in ("object_statistic_features", "object_momentum", "object_mean"):
            self.register_buffer(name, torch.zeros(num_class, C))

    def forward(self, batch_dict):
        if self.training:
            raise NotImplementedError("training is not ported; call .eval()")
        s_out = self.s_head(
            batch_dict["s_point_coords"], batch_dict["s_point_features"],
            batch_dict["s_point_valid"], batch_dict["s_last_sp_tensor"],
            batch_dict["s_last_centroid_xyz"], self.object_statistic_features)
        batch_dict["batch_cls_preds"] = s_out["cls_preds"]
        batch_dict["batch_box_preds"] = s_out["box_preds"]
        batch_dict["cls_preds_normalized"] = False
        batch_dict["point_vote_coords"] = s_out["vote_xyz"]
        return batch_dict
