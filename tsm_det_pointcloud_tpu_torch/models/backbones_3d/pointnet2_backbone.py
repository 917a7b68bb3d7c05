"""The PointNet++ point backbones (counterpart of
tsm_det_pointcloud_tpu/models/backbones_3d/pointnet2_backbone.py:25,
`PointNet2MSG`, PointRCNN's, and :74, `PointNet2FSMSG`, 3DSSD's).

PointNet2MSG:

SA_CONFIG's levels go down (`sa{i}`, PointnetSAModuleMSG: d-fps of NPOINTS[i]
centres, multi-scale ball query and MLPs), then FP_MLPS' levels come back up
from the coarsest to the raw points (`fp{i}`, PointnetFPModule: level i + 1's
features, the decoded ones where there are, interpolated at level i's points
beside level i's own). Each level's validity is that of its sampled points.

batch_dict in: points (B, N, 3 + C), points_mask (B, N); out:
point_features (B, N, FP_MLPS[0][-1]), point_coords (B, N, 3), point_valid.

PointNet2FSMSG: SA_CONFIG's levels go down only (`sa{i}`,
PointnetSAModuleFSMSG: NPOINT_LIST[i] centres by the SAMPLE_METHOD_LIST[i]
methods over the SAMPLE_RANGE_LIST[i] ranges of the level before,
multi-scale grouping dilated with DILATED_RADIUS_GROUP, AGGREGATION_MLPS and
CONFIDENCE_MLPS where given); each level's confidence logits feed the next
level's s-fps. Out: the last level's point_features (B, M, C),
point_coords, point_valid and point_scores (or None), and the levels'
point_coords_list, point_scores_list (the levels that score) and
point_valid_list.
"""
from __future__ import annotations

from torch import nn

from .pointnet2_modules import PointnetFPModule, PointnetSAModuleFSMSG, PointnetSAModuleMSG


class PointNet2MSG(nn.Module):
    def __init__(self, model_cfg, input_channels, meta=None):
        super().__init__()
        self.model_cfg = model_cfg
        sa = model_cfg["SA_CONFIG"]
        widths = [int(input_channels) - 3]
        for i, npoint in enumerate(sa["NPOINTS"]):
            m = PointnetSAModuleMSG(npoint, sa["RADIUS"][i], sa["NSAMPLE"][i], sa["MLPS"][i],
                                    widths[-1])
            setattr(self, f"sa{i}", m)
            widths.append(m.out_channels)
        self.n_sa = len(sa["NPOINTS"])
        fp_mlps = model_cfg["FP_MLPS"]
        self.n_fp = len(fp_mlps)
        known = widths[self.n_fp]
        for i in range(self.n_fp - 1, -1, -1):
            setattr(self, f"fp{i}", PointnetFPModule(fp_mlps[i], known + widths[i]))
            known = int(fp_mlps[i][-1])
        self.num_point_features = int(fp_mlps[0][-1])

    def forward(self, batch_dict):
        points = batch_dict["points"]
        valid = batch_dict["points_mask"]
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        xyz_list, feat_list, valid_list = [xyz], [feats], [valid]
        for i in range(self.n_sa):
            new_xyz, new_feats, new_valid = getattr(self, f"sa{i}")(
                xyz_list[-1], feat_list[-1], valid_list[-1])
            xyz_list.append(new_xyz)
            feat_list.append(new_feats)
            valid_list.append(new_valid)
        for i in range(self.n_fp - 1, -1, -1):
            feat_list[i] = getattr(self, f"fp{i}")(
                xyz_list[i], xyz_list[i + 1], feat_list[i], feat_list[i + 1], valid_list[i + 1],
                valid_list[i])
        batch_dict["point_features"] = feat_list[0]
        batch_dict["point_coords"] = xyz_list[0]
        batch_dict["point_valid"] = valid_list[0]
        return batch_dict


class PointNet2FSMSG(nn.Module):
    def __init__(self, model_cfg, input_channels, meta=None):
        super().__init__()
        self.model_cfg = model_cfg
        sa = model_cfg["SA_CONFIG"]
        agg, conf = sa.get("AGGREGATION_MLPS"), sa.get("CONFIDENCE_MLPS")
        c = int(input_channels) - 3
        self.n_sa = len(sa["NPOINT_LIST"])
        for i in range(self.n_sa):
            m = PointnetSAModuleFSMSG(
                sa["NPOINT_LIST"][i], sa["SAMPLE_RANGE_LIST"][i], sa["SAMPLE_METHOD_LIST"][i],
                sa["RADIUS"][i], sa["NSAMPLE"][i], sa["MLPS"][i], c,
                dilated_group=bool(sa.get("DILATED_RADIUS_GROUP", False)),
                aggregation_mlp=list(agg[i]) if agg else None,
                confidence_mlp=list(conf[i]) if conf else None,
                num_class=int(sa.get("NUM_CLASS", 3)),
                weight_gamma=float(sa.get("WEIGHT_GAMMA", 1.0)))
            setattr(self, f"sa{i}", m)
            c = m.out_channels
        self.num_point_features = c

    def forward(self, batch_dict):
        points = batch_dict["points"]
        valid = batch_dict["points_mask"]
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        scores = None
        coords_list, scores_list, valid_list = [], [], []
        for i in range(self.n_sa):
            xyz, feats, valid, scores = getattr(self, f"sa{i}")(xyz, feats, valid, scores)
            coords_list.append(xyz)
            valid_list.append(valid)
            if scores is not None:
                scores_list.append(scores)
        batch_dict["point_features"] = feats
        batch_dict["point_coords"] = xyz
        batch_dict["point_valid"] = valid
        batch_dict["point_scores"] = scores
        batch_dict["point_coords_list"] = coords_list
        batch_dict["point_scores_list"] = scores_list
        batch_dict["point_valid_list"] = valid_list
        return batch_dict
