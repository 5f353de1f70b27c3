"""Solver configuration: SPOptions and the --sp_* CLI convention.

Role of the reference's ``StrumpackOptions.{hpp,cpp}`` (SPOptions at :217,
enums at :51-178, getopt_long CLI parser at :626 area).  Flag names keep the
reference's ``--sp_*`` prefixes for driveability; every options object
supports ``set_from_command_line(argv)`` like every reference test/example
does (test/test_sparse_seq.cpp:47).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field


class ReorderingStrategy(enum.Enum):  # StrumpackOptions.hpp:61
    NATURAL = "natural"
    METIS = "metis"          # mapped to the built-in general ND
    PARMETIS = "parmetis"    # external-lib names accepted; the built-in
    SCOTCH = "scotch"        # general ND covers the graph-partitioning role
    PTSCOTCH = "ptscotch"
    ND = "nd"                # built-in BFS-bisection nested dissection
    AND = "and"              # ANDSparspak role == the built-in BFS ND
    GEOMETRIC = "geometric"
    RCM = "rcm"
    AMD = "amd"
    MMD = "mmd"              # multiple minimum degree (genmmd role)
    MLF = "mlf"              # minimum local fill
    SPECTRAL = "spectral"    # Fiedler-vector recursive bisection ND


class CompressionType(enum.Enum):  # StrumpackOptions.hpp:92
    NONE = "none"
    BLR = "blr"
    HSS = "hss"
    HODLR = "hodlr"
    HODBF = "hodbf"   # HODLR with butterfly off-diagonal front blocks
    # composite per-front-size schemes (FrontFactory.hpp:92-124):
    # large fronts HODLR, medium BLR (+ small lossy for ZFP_BLR_HODLR)
    BLR_HODLR = "blr_hodlr"
    ZFP_BLR_HODLR = "zfp_blr_hodlr"
    LOSSY = "lossy"
    # LOSSLESS (ZFP reversible mode in the reference): factors kept exact.
    # On TPU there is no on-chip lossless float codec that beats plain f32
    # storage, so this stores full precision — residuals are exact like the
    # reference's, without the reference's ~1.2x memory saving.
    LOSSLESS = "lossless"


class MatchingJob(enum.Enum):  # StrumpackOptions.hpp:120
    NONE = "none"
    MAX_CARDINALITY = "mc"                   # MC64 job 1
    MAX_SMALLEST_DIAGONAL = "msd"            # MC64 job 2 (bottleneck)
    MAX_SMALLEST_DIAGONAL_2 = "msd2"         # MC64 job 3 (same objective)
    MAX_DIAGONAL_SUM = "mds"                 # MC64 job 4
    MAX_DIAGONAL_PRODUCT_SCALING = "mpds"    # MC64 job 5 (+ scalings)
    COMBBLAS = "awpm"                        # AWPM/CombBLAS role


class EquilibrationType(enum.Enum):  # StrumpackOptions.hpp:132
    NONE = "none"
    ROW = "row"
    COLUMN = "col"
    BOTH = "both"


class KrylovSolver(enum.Enum):  # StrumpackOptions.hpp:166
    AUTO = "auto"
    DIRECT = "direct"
    REFINE = "refine"
    PREC_GMRES = "prec_gmres"
    GMRES = "gmres"
    PREC_BICGSTAB = "prec_bicgstab"
    BICGSTAB = "bicgstab"


class GramSchmidtType(enum.Enum):  # StrumpackOptions.hpp:157
    CLASSICAL = "classical"
    MODIFIED = "modified"


class ProportionalMapping(enum.Enum):  # StrumpackOptions.hpp:51
    FLOPS = "flops"
    FACTOR_MEMORY = "factor_memory"
    PEAK_MEMORY = "peak_memory"


@dataclass
class BLROptions:
    """--blr_* options (BLR/BLROptions.hpp:128-140 defaults)."""
    rel_tol: float = 1e-4
    abs_tol: float = 1e-10
    leaf_size: int = 256
    max_rank: int = 5000
    # "weak" compresses every off-diagonal tile of an eliminated block
    # row/col; "strong" keeps the tiles adjacent to the diagonal dense
    # (BLR/BLROptions.hpp:62 Admissibility)
    admissibility: str = "weak"
    # update schedule (BLR/BLROptions.hpp:65 BLRFactorAlgorithm):
    # "rl" right-looking eager updates, "ll" left-looking with LUAR-style
    # accumulated low-rank updates (BLRMatrix.hpp:275-300) applied as one
    # contraction per block row/col and once for the Schur complement.
    factor_algorithm: str = "rl"
    # tile compressor (BLR/BLROptions.hpp:129 LowRankAlgorithm, reference
    # default RRQR): "rrqr" (geqp3tol-role pivoted QR, ops/rrqr.py),
    # "aca", "baca", or "svd" (tightest ranks, heavy to compile on TPU)
    low_rank_algorithm: str = "rrqr"
    baca_blocksize: int = 4
    # keep contribution blocks (F22) BLR-compressed between levels — the
    # memory-efficient variant (FrontBLR.cpp:69 build_front_cols /
    # F22blr_): peak factor memory drops from the dense multifrontal's
    cb_compression: bool = False
    # rank cap of the compressed-CB tiles (0 = tile/4): static BLRCB
    # storage scales linearly with it — the HBM lever at 100^3 scale
    cb_rank_cap: int = 0


@dataclass
class HSSOptions:
    """--hss_* options (HSS/HSSOptions.hpp:465-489 defaults)."""
    rel_tol: float = 1e-2
    abs_tol: float = 1e-8
    leaf_size: int = 512
    d0: int = 128
    dd: int = 64
    max_rank: int = 5000
    # construct root HSS fronts by randomized sampling of the front action
    # (sparse spmv + child-CB products) instead of dense assembly — the
    # reference's FrontHSS::random_sampling path (FrontHSS.cpp:241)
    sampling: bool = False


@dataclass
class SPOptions:
    verbose: bool = False
    # outer solver (StrumpackOptions.hpp:166-199,1308)
    krylov_solver: KrylovSolver = KrylovSolver.AUTO
    rel_tol: float = 1e-6
    abs_tol: float = 1e-10
    maxit: int = 5000
    gmres_restart: int = 30
    gram_schmidt: GramSchmidtType = GramSchmidtType.MODIFIED
    # reordering
    reordering_method: ReorderingStrategy = ReorderingStrategy.ND
    nd_leaf: int = 16
    nx: int = 0
    ny: int = 1
    nz: int = 1
    components: int = 1
    separator_width: int = 1
    # scaling / matching
    matching: MatchingJob = MatchingJob.NONE
    equilibration: bool = True
    equilibration_type: EquilibrationType = EquilibrationType.BOTH
    # pivoting / symmetry
    pivoting: bool = True
    replace_tiny_pivots: bool = True
    symmetric: bool = False
    positive_definite: bool = False
    # compression (FrontFactory thresholds, StrumpackOptions.hpp:601-666)
    compression: CompressionType = CompressionType.NONE
    compression_min_sep_size: int = 256
    # re-partition big separators' graphs so BLR tiles / HSS leaves are
    # graph clusters (MatrixReordering::separator_reordering role)
    separator_reordering: bool = True
    # double saturated rank caps and re-trace (HSS adaptive d0+dd role,
    # HSSMatrix.compress.hpp:37-100) so tolerance alone drives accuracy
    adaptive_rank: bool = True
    compression_min_front_size: int = 512
    compression_leaf_size: int = 128
    # per-type thresholds for the composite schemes
    # (StrumpackOptions.hpp:1023-1040 compression_min_sep_size(l)):
    # BLR_HODLR / ZFP_BLR_HODLR pick HODLR above hodlr_min_sep_size, BLR
    # above compression_min_sep_size, lossy above lossy_min_sep_size
    hodlr_min_sep_size: int = 512
    lossy_min_sep_size: int = 8
    lossy_precision: int = 16    # bits for LOSSY factor storage (4, 8 or 16)
    # HODLR fronts switch to butterfly-compressed off-diagonal blocks
    # (HODBF) when > 0 (HODLROptions::butterfly_levels role); --sp_compression
    # hodbf implies it for all levels
    hodlr_butterfly_levels: int = 0
    blr: BLROptions = field(default_factory=BLROptions)
    hss: HSSOptions = field(default_factory=HSSOptions)
    # numeric dtypes (TPU-first: f32 factor + f64 refinement by default on
    # TPU; tests on CPU may use f64 factor directly)
    factor_dtype: str = "float64"
    refine_dtype: str = "float64"
    # TPU matmul precision inside the f32 factor/solve: "float32" (full,
    # 3-pass bf16) or "bfloat16" (fast preconditioner mode, more IR its)
    matmul_precision: str = "float32"
    # HODBF fronts: factor F11 by the TRUE direct butterfly
    # factorization (HODBFMatrix.factor, bpack_factor role) instead of
    # HODLR-SMW when the front's HODLR tree has >= 1 level
    hodbf_direct: bool = True
    # node sizes at or below this factor densely inside the butterfly
    # factorization (HODBFMatrix.factor dense_cutoff): larger values
    # shrink the factor PROGRAM (the deep butterfly solve chains are
    # what makes the XLA compile of HODBF factor programs expensive —
    # re-paid per process on the remote-compile chip backend) at the
    # cost of denser G/W blocks; chip ablation (PERF.md r5): helmholtz
    # 32^3 cold factor 439 s (256) -> 336 s (512) -> 194 s (1024) at
    # identical residual/its — 1024 is the default; lower it for huge
    # fronts where the deep butterfly chains pay asymptotically
    hodbf_dense_cutoff: int = 1024
    # complex scalars via the real-equivalent 2x2-block expansion
    # (CSRMatrix.to_real_interleaved): the TPU chip backend has no
    # complex arithmetic, so complex64/128 inputs factor as interleaved
    # real f32/f64 systems when enabled (2x native-complex flops).
    complex_via_real: bool = False

    def describe(self) -> str:
        """--help text listing every supported flag (reference -h parity)."""
        import io
        out = io.StringIO()
        out.write("# sparse solver options (--sp_*):\n")
        for line in (
            "--sp_verbose / --sp_quiet",
            "--sp_Krylov_solver auto|direct|refine|prec_gmres|gmres|"
            "prec_bicgstab|bicgstab",
            "--sp_rel_tol <float>   --sp_abs_tol <float>   --sp_maxit <int>",
            "--sp_gmres_restart <int>   --sp_gram_schmidt_type "
            "classical|modified",
            "--sp_reordering_method natural|metis|parmetis|scotch|ptscotch|nd|and|"
            "geometric|rcm|amd|mmd|mlf|spectral",
            "--sp_nd_leaf <int>  --sp_nx/--sp_ny/--sp_nz <int>  "
            "--sp_components <int>  --sp_separator_width <int>",
            "--sp_matching 0-6|none|mc|msd|msd2|mds|mpds|awpm   "
            "--sp_enable/disable_equilibration",
            "--sp_enable/disable_pivoting   "
            "--sp_enable/disable_replace_tiny_pivots",
            "--sp_enable/disable_symmetric   "
            "--sp_enable/disable_positive_definite",
            "--sp_compression none|blr|hss|hodlr|hodbf|blr_hodlr|"
            "zfp_blr_hodlr|lossy|lossless",
            "--sp_hodlr_min_sep_size <int>  --sp_lossy_min_sep_size <int>",
            "--hodlr_leaf_size/--hodlr_max_rank <int>  "
            "--hodlr_rel_tol <float>  --hodlr_butterfly_levels <int>",
            "--sp_compression_min_sep_size <int>  "
            "--sp_compression_min_front_size <int>  "
            "--sp_compression_leaf_size <int>  --sp_lossy_precision 4|8|16",
        ):
            out.write("  " + line + "\n")
        out.write("# BLR options (--blr_*): leaf_size, max_rank, rel_tol, "
                  "abs_tol, admissibility weak|strong,\n"
                  "#   factor_algorithm RL|LL|COMB|STAR (LL/COMB/STAR = "
                  "LUAR-accumulated updates)\n")
        out.write("# HSS options (--hss_*): leaf_size, d0, dd, max_rank, "
                  "rel_tol, abs_tol,\n"
                  "#   --hss_enable/disable_sampling (randomized-sampling "
                  "root fronts, no dense assembly)\n")
        return out.getvalue()

    def set_from_command_line(self, argv) -> list:
        """Parse --sp_/--blr_/--hss_ flags; returns unrecognized args."""
        rest = []
        i = 0
        argv = list(argv)
        enum_map = {
            "sp_reordering_method": ("reordering_method", ReorderingStrategy),
            "sp_compression": ("compression", CompressionType),
            "sp_matching": ("matching", MatchingJob),
            "sp_Krylov_solver": ("krylov_solver", KrylovSolver),
            "sp_gram_schmidt_type": ("gram_schmidt", GramSchmidtType),
        }
        int_map = {
            "sp_maxit": "maxit", "sp_gmres_restart": "gmres_restart",
            "sp_nd_leaf": "nd_leaf", "sp_nx": "nx", "sp_ny": "ny",
            "sp_nz": "nz", "sp_components": "components",
            "sp_separator_width": "separator_width",
            "sp_compression_min_sep_size": "compression_min_sep_size",
            "sp_compression_min_front_size": "compression_min_front_size",
            "sp_compression_leaf_size": "compression_leaf_size",
            "sp_lossy_precision": "lossy_precision",
            "blr_leaf_size": ("blr", "leaf_size"),
            "blr_max_rank": ("blr", "max_rank"),
            "blr_BACA_blocksize": ("blr", "baca_blocksize"),
            "hss_leaf_size": ("hss", "leaf_size"),
            "hss_d0": ("hss", "d0"), "hss_dd": ("hss", "dd"),
            "hss_max_rank": ("hss", "max_rank"),
            # HODLR fronts share the HSS cluster/rank knobs (the reference
            # keeps a separate HODLROptions; the knobs' roles coincide here)
            "hodlr_leaf_size": ("hss", "leaf_size"),
            "hodlr_max_rank": ("hss", "max_rank"),
            "hodlr_butterfly_levels": "hodlr_butterfly_levels",
            "sp_hodbf_dense_cutoff": "hodbf_dense_cutoff",
            "sp_hodlr_min_sep_size": "hodlr_min_sep_size",
            "sp_lossy_min_sep_size": "lossy_min_sep_size",
        }
        float_map = {
            "sp_rel_tol": "rel_tol", "sp_abs_tol": "abs_tol",
            "blr_rel_tol": ("blr", "rel_tol"),
            "blr_abs_tol": ("blr", "abs_tol"),
            "hss_rel_tol": ("hss", "rel_tol"),
            "hss_abs_tol": ("hss", "abs_tol"),
            "hodlr_rel_tol": ("hss", "rel_tol"),
            "hodlr_abs_tol": ("hss", "abs_tol"),
        }
        bool_flags = {
            "sp_verbose": ("verbose", True),
            "sp_quiet": ("verbose", False),
            "sp_enable_replace_tiny_pivots": ("replace_tiny_pivots", True),
            "sp_disable_replace_tiny_pivots": ("replace_tiny_pivots", False),
            "sp_enable_pivoting": ("pivoting", True),
            "sp_disable_pivoting": ("pivoting", False),
            "sp_enable_equilibration": ("equilibration", True),
            "sp_disable_equilibration": ("equilibration", False),
            "sp_enable_symmetric": ("symmetric", True),
            "sp_disable_symmetric": ("symmetric", False),
            "sp_enable_positive_definite": ("positive_definite", True),
            "sp_disable_positive_definite": ("positive_definite", False),
            "sp_enable_separator_reordering": ("separator_reordering", True),
            "sp_disable_separator_reordering":
                ("separator_reordering", False),
            "sp_enable_adaptive_rank": ("adaptive_rank", True),
            "sp_disable_adaptive_rank": ("adaptive_rank", False),
            "blr_enable_cb_compression": (("blr", "cb_compression"), True),
            "blr_disable_cb_compression": (("blr", "cb_compression"), False),
        }
        hss_bool = {
            "hss_enable_sampling": True,
            "hss_disable_sampling": False,
        }

        def setval(spec, val):
            if isinstance(spec, tuple):
                setattr(getattr(self, spec[0]), spec[1], val)
            else:
                setattr(self, spec, val)

        while i < len(argv):
            a = argv[i]
            if a in ("-h", "--help"):
                print(self.describe())
                i += 1
                continue
            if not a.startswith("--"):
                rest.append(a)
                i += 1
                continue
            name = a[2:]
            val = None
            if "=" in name:
                name, val = name.split("=", 1)
            if name in bool_flags:
                attr, v = bool_flags[name]
                if isinstance(attr, tuple):
                    setattr(getattr(self, attr[0]), attr[1], v)
                else:
                    setattr(self, attr, v)
            elif name in hss_bool:
                self.hss.sampling = hss_bool[name]
            elif name == "blr_admissibility":
                if val is None:
                    i += 1
                    val = argv[i]
                if val.lower() not in ("weak", "strong"):
                    raise ValueError(f"--blr_admissibility {val}")
                self.blr.admissibility = val.lower()
            elif name == "blr_factor_algorithm":
                if val is None:
                    i += 1
                    val = argv[i]
                v = val.lower()
                # reference names (BLROptions.hpp:65): RL/LL/COMB/STAR/
                # COLWISE; COMB and STAR are accumulation variants — our
                # "ll" IS the accumulated (LUAR) schedule, so map them.
                alias = {"rl": "rl", "ll": "ll", "comb": "ll", "star": "ll",
                         "colwise": "rl"}
                if v not in alias:
                    raise ValueError(f"--blr_factor_algorithm {val}")
                self.blr.factor_algorithm = alias[v]
            elif name == "blr_low_rank_algorithm":
                if val is None:
                    i += 1
                    val = argv[i]
                v = val.lower()
                if v not in ("rrqr", "aca", "baca", "svd"):
                    raise ValueError(f"--blr_low_rank_algorithm {val}")
                self.blr.low_rank_algorithm = v
            elif name in enum_map:
                attr, E = enum_map[name]
                _mc64_codes = {"0": "none", "1": "mc", "2": "msd",
                               "3": "msd2", "4": "mds", "5": "mpds",
                               "6": "awpm"}
                if val is None:
                    i += 1
                    val = argv[i]
                v = val.lower()
                if E is MatchingJob:
                    v = _mc64_codes.get(v, v)
                setattr(self, attr, E(v))
            elif name in int_map:
                if val is None:
                    i += 1
                    val = argv[i]
                setval(int_map[name], int(val))
            elif name in float_map:
                if val is None:
                    i += 1
                    val = argv[i]
                setval(float_map[name], float(val))
            else:
                rest.append(a)
            i += 1
        return rest
