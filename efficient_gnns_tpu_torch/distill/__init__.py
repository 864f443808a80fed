from efficient_gnns_tpu_torch.distill.artifacts import (
    load_teacher_dump,
    save_teacher_dump,
    teacher_dump_path,
)
from efficient_gnns_tpu_torch.distill.criteria import cls_ce, kd_criterion, kd_term

__all__ = [
    "cls_ce",
    "kd_criterion",
    "kd_term",
    "load_teacher_dump",
    "save_teacher_dump",
    "teacher_dump_path",
]
