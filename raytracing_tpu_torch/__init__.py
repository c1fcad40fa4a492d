"""raytracing_tpu_torch — the PyTorch and CUDA port of raytracing_tpu.

A second package beside the JAX reference ``raytracing_tpu``: the same 2-D
batched ray tracer (step methods op1-op12, the four reference scenarios,
the physics oracles, the analytic fields and the reference's sampled media:
stratified tables and the 2-D spline grid, parity and C1 forms; the dynamic
tier — paraxial spreading, KMAH caustics, amplitudes — and the eigenray
solver with transmission loss; the df32 precision tier, double-word float32
on the analytic fields and on split-word sampled media; user-defined
media, ``CustomMedium``, traced into kernels of their own; and the 3-D
kinematic tier: ``trace3d`` and ``fast_trace3`` on the analytic 3-D
fields, lifted and user-defined 3-D media and tri-Hermite sampled 3-D
grids), written as
plain torch functions on tensors, with the JAX package's TPU kernels
replaced by CUDA C++ kernels for the H100 (``csrc/``, built at first use by
:mod:`raytracing_tpu_torch.kernels.build`; a custom medium's by
:mod:`raytracing_tpu_torch.kernels.custom`).
It imports neither jax nor ``raytracing_tpu``.
"""

__version__ = "0.1.0"

from raytracing_tpu_torch.config import (  # noqa: F401
    DELTA_S,
    SIGMA,
    ScenarioConfig,
    scenario,
)
from raytracing_tpu_torch.engine.df_grid import (  # noqa: F401
    df_c1_medium_from_samples,
    df_c1_profile_from_samples,
    df_eval_profile_medium,
    df_grid_medium_from_samples,
    df_grid_trace,
)
from raytracing_tpu_torch.engine.dynamic import (  # noqa: F401
    CROSS_COLS,
    DYN_COLS,
    CrossingFan,
    CrossingPick,
    DynamicResult,
    spreading_amplitude,
    trace_crossings_fan,
    trace_crossings_pick,
    trace_dynamic,
    transmission_loss_db,
)
from raytracing_tpu_torch.engine.eigenray import (  # noqa: F401
    Eigenrays,
    coherent_tl,
    find_eigenrays,
    incoherent_tl,
    pressure,
)
from raytracing_tpu_torch.engine.fast import (  # noqa: F401
    FastResult,
    fast_dynamic,
    fast_trace,
    fast_trace3,
)
from raytracing_tpu_torch.engine.trace import TraceResult, trace  # noqa: F401
from raytracing_tpu_torch.engine.trace3d import (  # noqa: F401
    Trace3Result,
    bouguer_invariant,
    trace3d,
)
from raytracing_tpu_torch.media.c1 import (  # noqa: F401
    C1GridMedium,
    C1StratifiedMedium,
    build_c1_medium,
    build_c1_stratified,
    c1_medium_from_samples,
    c1_stratified_from_samples,
)
from raytracing_tpu_torch.media.fields3d import (  # noqa: F401
    Analytic3D,
    Custom3D,
    Stratified3D,
    analytic_medium3,
)
from raytracing_tpu_torch.media.grid3 import (  # noqa: F401
    C1Grid3Medium,
    c1_medium3_from_samples,
)
from raytracing_tpu_torch.media.hermite import (  # noqa: F401
    HermiteGridMedium,
    build_hermite_medium,
)
from raytracing_tpu_torch.kernels.dynamic import DynFinal  # noqa: F401
from raytracing_tpu_torch.media.medium import (  # noqa: F401
    AnalyticMedium,
    CustomMedium,
    analytic_medium,
)
from raytracing_tpu_torch.media.samples import (  # noqa: F401
    compact_for_trace,
    medium_from_samples,
)
from raytracing_tpu_torch.media.spline import (  # noqa: F401
    GridMedium,
    StratifiedGridMedium,
    build_grid_medium,
    build_stratified_medium,
    grid_medium_from_samples,
    stratified_medium_from_samples,
)
from raytracing_tpu_torch.ops.registry import (  # noqa: F401
    ALIASES,
    ANISO_OPS,
    EXTENSION_OPS,
    OP_NAMES,
)

__all__ = [
    "DELTA_S", "SIGMA", "ScenarioConfig", "scenario", "TraceResult", "trace",
    "FastResult", "fast_trace", "AnalyticMedium", "analytic_medium",
    "CustomMedium", "DynamicResult", "DynFinal", "DYN_COLS", "CROSS_COLS",
    "CrossingFan", "CrossingPick", "trace_dynamic", "trace_crossings_fan",
    "trace_crossings_pick", "spreading_amplitude", "transmission_loss_db",
    "fast_dynamic", "Eigenrays", "find_eigenrays", "pressure", "coherent_tl",
    "incoherent_tl",
    "GridMedium", "StratifiedGridMedium", "HermiteGridMedium", "C1GridMedium",
    "C1StratifiedMedium", "build_grid_medium", "build_stratified_medium",
    "grid_medium_from_samples", "stratified_medium_from_samples",
    "build_hermite_medium", "build_c1_medium", "build_c1_stratified",
    "c1_medium_from_samples", "c1_stratified_from_samples",
    "medium_from_samples", "compact_for_trace",
    "df_c1_medium_from_samples", "df_c1_profile_from_samples",
    "df_eval_profile_medium", "df_grid_medium_from_samples", "df_grid_trace",
    "ALIASES", "ANISO_OPS", "EXTENSION_OPS", "OP_NAMES",
    "Trace3Result", "trace3d", "bouguer_invariant", "fast_trace3",
    "C1Grid3Medium", "c1_medium3_from_samples", "Analytic3D", "Custom3D",
    "Stratified3D", "analytic_medium3",
]
