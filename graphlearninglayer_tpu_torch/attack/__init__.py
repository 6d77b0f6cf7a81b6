from .cw import make_gl_cw_attack, make_mlp_cw_attack
from .fgsm import (fgsm_attack_step, make_gl_fast_gradient_attack,
                   make_mlp_fast_gradient_attack,
                   make_sharded_gl_fast_gradient_attack)
from .pgd import make_gl_pgd_perturb, make_mlp_pgd_perturb

__all__ = [
    "make_gl_cw_attack", "make_mlp_cw_attack",
    "fgsm_attack_step", "make_gl_fast_gradient_attack",
    "make_mlp_fast_gradient_attack", "make_sharded_gl_fast_gradient_attack",
    "make_gl_pgd_perturb", "make_mlp_pgd_perturb",
]
