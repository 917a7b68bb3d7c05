"""CaDDN detector (counterpart of
tsm_det_pointcloud_tpu/models/detectors/caddn.py)."""
from __future__ import annotations

from .detector3d_template import Detector3DTemplate


class CaDDN(Detector3DTemplate):
    """ImageVFE -> Conv2DCollapse -> BaseBEVBackbone -> AnchorHeadSingle
    (module_list 0-3, the flax indices), camera only. At eval the head's
    decoded boxes feed the template's class-agnostic post-processing; in
    training the loss is the anchor head's plus the VFE's depth loss times
    VFE.LOSS_CONFIG.WEIGHTS.ddn_loss (3.0 where the config states none), and
    the tb_dict adds `depth_loss`."""

    def forward(self, batch_dict):
        batch_dict = self.forward_modules(batch_dict)
        if self.training:
            loss, tb = self.module_list[-1].loss(batch_dict)
            if "loss_depth" in batch_dict:
                weight = float(self.model_cfg.get("VFE", {}).get("LOSS_CONFIG", {}).get(
                    "WEIGHTS", {}).get("ddn_loss", 3.0))
                loss = loss + batch_dict["loss_depth"] * weight
                tb = {**tb, "depth_loss": batch_dict["loss_depth"]}
            batch_dict["loss"], batch_dict["tb_dict"] = loss, tb
        return batch_dict
