"""pyrayhf_tpu_torch — the vertical forward operator in PyTorch + CUDA.

The PyTorch port of ``pyrayhf_tpu``'s forward-operator slice: profile
stacks [B, N_alt] of electron density, |B| and ψ plus a frequency list in,
O/X virtual-height ionograms [B, F] out (NaN where the ray escapes). The
Pallas TPU kernels of that path are one hand-written CUDA kernel for
Hopper (``csrc/ionogram.cu``), built with ``nvcc`` at first use; on CPU
tensors every kernel wrapper runs its plain PyTorch version instead.

Module and function names mirror the JAX package. This package imports
neither ``jax`` nor ``pyrayhf_tpu``.
"""

from .constants import C_KM_S, CP, G_P, R_E, constants
from .magnetoionic import (den2freq, find_mu_mup, find_mu_mup_masked, find_X,
                           find_Y, freq2den, mode_multiplier)
from .grid import (regrid_core, regrid_to_nonuniform_grid,
                   smooth_nonuniform_grid)
from .forward import (find_vh, vertical_forward_operator,
                      vertical_forward_operator_batch, vertical_phase_operator,
                      vh_and_mask)
from .pallas_vh import (ionogram_fast_xla, ionogram_pallas,
                        ionogram_pallas_gather, prepare_profile_tables)
from .config import OperatorConfig
from .io import load_input, profiles_to_torch, save_to_file
from . import (config, cuda_ext, forward, grid, io, magnetoionic,
               pallas_vh, profiling)

__version__ = "0.1.0"
