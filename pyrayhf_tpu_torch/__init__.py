"""pyrayhf_tpu_torch — pyrayhf_tpu in PyTorch + CUDA.

The PyTorch port of ``pyrayhf_tpu``, slice by slice:

* the vertical forward operator: profile stacks [B, N_alt] of electron
  density, |B| and ψ plus a frequency list in, O/X virtual-height
  ionograms [B, F] out (NaN where the ray escapes); its Pallas TPU kernels
  are one hand-written CUDA kernel for Hopper (``csrc/ionogram.cu``);
* the 2-D oblique ionogram: an [F, E] gradient-ODE ray fan through an
  altitude × range slice, homed onto a link
  (:func:`synthesize_oblique_ionogram_2d`); its ray-fan kernel is
  ``csrc/fan2d.cu``;
* the inversions: the parametric EDP model and its retrievals
  (:func:`model_VH`, :func:`minimize_parameters`, Levenberg–Marquardt by
  forward-mode AD in :func:`retrieve_gradient_batch`) and the true-height
  lamination (:func:`retrieve_profile` and its batch and joint O+X forms);
  the tensor-core one-hot resample kernel (``csrc/ionogram_mxu.cu``) is the
  ``engine="pallas_mxu"`` forward operator;
* the 1-D oblique link: Snell (frequency × elevation) fans of a stratified
  profile (:func:`trace_rays_spherical_snells` and its Cartesian and
  single-ray forms), the link's oblique ionogram
  (:func:`synthesize_oblique_ionogram`), MUF maps over profile batches
  (:func:`muf_map`, which runs the forward kernels), Faraday rotation and
  Doppler of the vertical path, the inversion of an oblique ionogram
  (:func:`retrieve_from_oblique`), the single-ray gradient tracers with the
  adaptive Dormand–Prince integrator, and the geodesy helpers;
* the 3-D slice: input volumes from the climatology and the IGRF
  (:func:`generate_input_3D`, :func:`calculate_magnetic_field`), the
  fixed-ψ 3-D tracers with their (elevation × azimuth) homing and the
  link's oblique ionogram (:func:`trace_rays_3d`, :func:`home_ray_3d`,
  :func:`synthesize_oblique_ionogram_3d`), and the anisotropic Haselgrove
  tracers (:func:`trace_rays_3d_anisotropic` and their homing and
  ionogram), all on the batched early-exit fan integrator; this slice runs
  no kernel of its own;
* mesh sharding (:mod:`pyrayhf_tpu_torch.parallel`): a (batch, freq) mesh
  of torch devices, in which a device may repeat, and sharded ionogram
  synthesis (the sweep kernel launched once per block), height quadrature,
  retrieval, 3-D fans and Doppler.

Kernels are built with ``nvcc`` at first use; on CPU tensors every kernel
wrapper runs its plain PyTorch version instead. Host data (numpy arrays,
lists, numbers) goes to the CUDA card unless the caller passes
``device="cpu"`` (or CPU tensors).

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
                        ionogram_pallas_gather, ionogram_pallas_mxu,
                        prepare_profile_tables)
from .interp import interp_exact
from .edp import (derive_dependent_F1_parameters, epstein_layer,
                  f2_bottom_b0b1, f2_bottom_thickness, f2_topside,
                  reconstruct_density_1level, reconstruct_density_continuous,
                  valley_transition)
from .retrieval import (minimize_parameters, model_VH, residual_VH,
                        retrieve_gradient, retrieve_gradient_batch)
from .true_height import (retrieve_profile, retrieve_profile_batch,
                          retrieve_profile_joint)
from .config import (GradientTracerConfig, OperatorConfig, RetrievalConfig,
                     SnellConfig)
from .io import (field_from_numpy, load_checkpoint, load_input,
                 profiles_to_torch, save_checkpoint, save_to_file)
from .fields import (RefractiveField, bilinear,
                     build_mup_function,
                     build_refractive_index_interpolator_cartesian,
                     build_refractive_index_interpolator_spherical,
                     eval_refractive_index_and_grad, grad_axis_ord2,
                     gradient_ord2, make_n_and_grad, n_and_grad,
                     n_and_grad_rphi, uniform_axis)
from .absorption import (absorption_coefficient, collision_frequency,
                         vertical_absorption_operator)
from .ground import (GROUND_PRESETS, fresnel_coefficients,
                     fresnel_coefficients_real, ground_reflection_loss_db,
                     resolve_ground)
from .gradient import (trace_ray_cartesian_gradient,
                       trace_ray_spherical_gradient,
                       trace_rays_cartesian_gradient,
                       trace_rays_spherical_gradient)
from .pallas_ray import fan_2d_pallas, fan_2d_pallas_available
from .geodesy import (adjust_longitude, azimuth_between_points, calculate_gcd,
                      earth_radius_at_latitude, great_circle_point,
                      oblique_to_vertical, vertical_to_magnetic_angle)
from .rays import (event_ground, event_x_left, event_x_right, event_z_bottom,
                   event_z_top, find_turning_point, ray_rhs_cartesian,
                   rhs_spherical, tan_from_mu_scalar)
from .snell import (trace_ray_cartesian_snells, trace_ray_spherical_snells,
                    trace_rays_cartesian_snells, trace_rays_spherical_snells)
from .oblique import (synthesize_oblique_ionogram,
                      synthesize_oblique_ionogram_2d)
from .muf import (muf_from_profile, muf_from_vertical_ionogram, muf_map,
                  vertical_to_oblique)
from .faraday import faraday_rotation_vertical
from .doppler import doppler_shift_vertical, phase_height_and_mask
from .oblique_inversion import retrieve_from_oblique
from .igrf import calculate_magnetic_field
from .envgen import (find_mean_gradient_error, generate_input_1D,
                     generate_input_2D, generate_input_3D)
from .trace3d import (build_field_3d, home_ray_3d,
                      synthesize_oblique_ionogram_3d, trace_ray_3d,
                      trace_rays_3d)
from .trace3d_aniso import (build_field_3d_aniso, igrf_volume,
                            home_ray_3d_anisotropic,
                            synthesize_oblique_ionogram_3d_anisotropic,
                            trace_ray_3d_anisotropic,
                            trace_rays_3d_anisotropic)
from . import (absorption, ccir, config, cuda_ext, doppler, edp, envgen,
               faraday, fields, forward, geodesy, gradient, grid, ground,
               igrf, igrf13_table, igrf_history, interp, io, magnetoionic,
               muf, oblique, oblique_inversion, pallas_ray, pallas_vh,
               parallel, profiling, rays, retrieval, snell, trace3d,
               trace3d_aniso, true_height)

__version__ = "0.1.0"
