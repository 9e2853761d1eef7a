"""Structured plans and the hand-written Hopper kernels they launch
(``csrc/``), selected by ``plans.build_matvec_plan`` and
``plans.build_matmul_plan``."""
