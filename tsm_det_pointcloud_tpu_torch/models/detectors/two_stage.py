"""Two-stage detectors (counterpart of
tsm_det_pointcloud_tpu/models/detectors/two_stage.py): the module list in
the JAX topology's order, then in training the loss of the dense head plus
the point head's `loss_point` and the RoI head's `loss_rcnn`."""
from __future__ import annotations

from .detector3d_template import Detector3DTemplate


class TwoStageBase(Detector3DTemplate):
    """In training (`.train()`, a batch with gt_boxes and gt_boxes_mask) the
    forward adds `loss`, the sum of the dense head's loss, `loss_point` and
    `loss_rcnn`, and `tb_dict`: the dense head's terms, `point_loss` and
    the RoI head's terms. At eval the RoI head's refined boxes, scores and
    `roi_labels` feed the template's post-processing."""

    def forward(self, batch_dict):
        batch_dict = self.forward_modules(batch_dict)
        if self.training:
            loss, tb = 0.0, {}
            head = self.dense_head
            if head is not None:
                loss, tb = head.loss(batch_dict)
                tb = dict(tb)
            if "loss_point" in batch_dict:
                loss = loss + batch_dict["loss_point"]
                tb["point_loss"] = batch_dict["loss_point"]
            if "loss_rcnn" in batch_dict:
                loss = loss + batch_dict["loss_rcnn"]
                tb.update(batch_dict.get("tb_dict_rcnn", {}))
            batch_dict["loss"] = loss
            batch_dict["tb_dict"] = tb
        return batch_dict

    @property
    def dense_head(self):
        from ..dense_heads.anchor_head import AnchorHeadSingle

        return next((m for m in self.module_list if isinstance(m, AnchorHeadSingle)), None)


class PartA2Net(TwoStageBase):
    """MeanVFE -> UNetV2 -> HeightCompression -> BaseBEVBackbone ->
    AnchorHeadSingle (RPN) + PointIntraPartOffsetHead -> PartA2FCHead
    (module_list 0-6, the flax indices)."""


class PointRCNN(TwoStageBase):
    """PointNet2MSG -> PointHeadBox (per-point proposals) -> PointRCNNHead
    (module_list 0-2, the flax indices). Its training loss is `loss_point`
    plus `loss_rcnn` (no dense head), tb_dict `point_loss` and the RCNN
    terms."""


class VoxelRCNN(TwoStageBase):
    """MeanVFE -> VoxelBackBone8x -> HeightCompression -> BaseBEVBackbone ->
    AnchorHeadSingle (RPN) -> VoxelRCNNHead, RoI-grid pooling over the
    sparse levels (module_list 0-5, the flax indices). Its training loss is
    the RPN's and the RCNN's."""


class SECONDNetIoU(TwoStageBase):
    """SECOND's modules -> SECONDHead, the IoU branch over BEV-pooled RoIs
    (module_list 0-5): its scores are rectified as cls^(1-a) * iou^a before
    the final NMS. Its training loss is the RPN's and `rcnn_iou_loss`."""


class PVSSDA(TwoStageBase):
    """The TSM project's PVSSDA, the module list its config wires
    (`models.build_network`'s generic topology). On its point topology: a
    PointNet++ backbone (PointNet2MSG or 3DSSD's PointNet2FSMSG) -> a
    PointHeadBox-family head, a box a point (module_list 0-1, the flax
    indices); no RoI head, so the template's post-processing takes the
    point head's boxes; training loss `loss_point`, tb_dict `point_loss`.
    On its BEV topology: PillarVFE, PointNet2MSG, the pillar scatter, the
    BEV backbone, the VoxelPointCross neck and an anchor head (module_list
    0-5), whose loss is the anchor head's. No loss reads a PointNet2FSMSG
    level's confidence scores, nor the neck's point branch (nor, through
    it, the PointNet++ backbone): their parameters get no gradient (the
    JAX package's is zero) and `unused_parameters` says so, for DDP."""

    @property
    def unused_parameters(self):
        from ..neck.voxel_point_cross import VoxelPointCross

        return any(getattr(m, "has_confidence", False) or isinstance(m, VoxelPointCross)
                   for m in self.modules())


class DSASNet(TwoStageBase):
    """The TSM project's DSASNet, `TwoStageBase` under another name (JAX
    two_stage.py:54-57), on the module list its config wires: dsasnet.yaml's
    MeanVFE -> DSASNetVoxelBackBone8x -> HeightCompression -> a BEV / point
    hybrid 2D backbone -> DSASNetHead (a box a key point) -> DSASNetRoIHead
    (PV-RCNN's RoI grid over the hybrid's points), module_list 0-5. Its
    training loss is `loss_point` plus the RoI head's. No loss reads the
    hybrid's own fg, cls and statistic-tag layers (SparsePointBackbone's
    `point_cls_preds` are overwritten by the point head's), nor the trunk's
    `conv_out` where no module reads the BEV map: their parameters get no
    gradient, as the JAX package's are zero, and `unused_parameters` says
    so, for DDP."""

    unused_parameters = True
