from efficient_gnns_tpu_torch.distill.criteria import cls_ce, kd_criterion, kd_term

__all__ = ["cls_ce", "kd_criterion", "kd_term"]
