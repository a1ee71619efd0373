"""fpcr_tpu — point-cloud registration in JAX (fast-point-cloud-registration).

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
``Carlos310197/Fast-Point-Cloud-Registration-with-GPUs`` (CUDA ICP thesis
code): point-to-point and point-to-plane ICP, brute-force NN matching
(a tiled XLA argmin, and a fused Pallas-Triton kernel on the GPU), kNN + PCA
normal estimation with an on-device closed-form 3x3 eigensolver, synthetic /
Stanford-Bunny / Ouster-OS1-16 datasets, a jitted convergence-gated ICP loop,
and multi-device scaling via shard_map + psum of moment matrices.

See SURVEY.md for the structural map of the reference and BASELINE.md for the
performance contract.
"""

__version__ = "0.4.0"

from .core.transforms import (
    RigidTransform,
    gt_transform,
    rotation_gt,
    rotation_x,
    rotation_y,
    rotation_z,
    rotation_zyx,
)
from .core.cloud import MaskedCloud, pad_cloud
from .core.metrics import evaluate_registration, rmse, transform_rmse
from .models.icp import (
    ICPConfig,
    ICPResult,
    icp_generalized,
    icp_iteration,
    icp_point_to_plane,
    icp_point_to_point,
    run_icp,
    tune_morton,
)
from .models.history import (
    ICPHistory,
    load_checkpoint,
    resume_icp,
    run_icp_with_history,
    save_checkpoint,
)
from .models.anderson import run_aa_icp
from .models.sgd_icp import run_sgd_icp
from .models.scaled_icp import ScaledICPResult, run_scaled_icp
from .models.odometry import OdometryResult, build_map, register_sequence
from .models.pose_graph import (
    PoseGraphResult,
    close_loops,
    detect_loop_closures,
    optimize_pose_graph,
)
from .models.global_reg import (
    GlobalRegResult,
    global_registration,
    register_global,
)
from .models.ndt import (NDTConfig, NDTResult, register_ndt,
                         resolve_ndt_config, run_ndt)
from .models.registry import METHODS, register
from .models.uncertainty import (
    information_from_covariance,
    registration_covariance,
)
from .ops.ndt import NDTGrid, build_ndt_grid, ndt_lookup
from .ops.fpfh import fpfh_features
from .ops.normals import estimate_normals, orient_normals
from .models.batch import register_batch
from .models.pipeline import CoarseToFineResult, icp_coarse_to_fine
from .ops.matching import gather_correspondences, nn_argmin, pairwise_sqdist
from .ops.grid import (build_voxel_table, grid_nn, suggest_cell_size,
                       voxel_downsample)
from .ops.solve import (
    kabsch_transform,
    point_to_plane_transform,
    umeyama_transform,
)
from .data.synthetic import RegistrationScene, surface_grid, synthetic_scene, transformed_scene
from .data.bunny import bunny_scene, load_bunny
from .data.ouster import hall_scene, load_hall_scan
from .data.pointcloud_io import (load_points, read_pcd, read_ply, write_pcd,
                                 write_ply)

__all__ = [
    "register",
    "METHODS",
    "register_batch",
    "run_aa_icp",
    "run_sgd_icp",
    "run_ndt",
    "register_ndt",
    "resolve_ndt_config",
    "optimize_pose_graph",
    "close_loops",
    "detect_loop_closures",
    "build_map",
    "PoseGraphResult",
    "registration_covariance",
    "information_from_covariance",
    "NDTConfig",
    "NDTResult",
    "NDTGrid",
    "build_ndt_grid",
    "ndt_lookup",
    "voxel_downsample",
    "icp_coarse_to_fine",
    "CoarseToFineResult",
    "ICPHistory",
    "run_icp_with_history",
    "save_checkpoint",
    "load_checkpoint",
    "resume_icp",
    "bunny_scene",
    "load_bunny",
    "hall_scene",
    "load_hall_scan",
    "load_points",
    "read_ply",
    "write_ply",
    "read_pcd",
    "write_pcd",
    "RigidTransform",
    "MaskedCloud",
    "ICPConfig",
    "ICPResult",
    "RegistrationScene",
    "gt_transform",
    "rotation_gt",
    "rotation_x",
    "rotation_y",
    "rotation_z",
    "rotation_zyx",
    "pad_cloud",
    "rmse",
    "transform_rmse",
    "evaluate_registration",
    "icp_generalized",
    "icp_iteration",
    "icp_point_to_plane",
    "icp_point_to_point",
    "run_icp",
    "tune_morton",
    "nn_argmin",
    "gather_correspondences",
    "pairwise_sqdist",
    "kabsch_transform",
    "umeyama_transform",
    "ScaledICPResult",
    "run_scaled_icp",
    "OdometryResult",
    "register_sequence",
    "GlobalRegResult",
    "global_registration",
    "register_global",
    "fpfh_features",
    "estimate_normals",
    "orient_normals",
    "point_to_plane_transform",
    "surface_grid",
    "synthetic_scene",
    "transformed_scene",
]
