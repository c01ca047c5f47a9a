"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with
its plain PyTorch version; the twin of ``svdsolver_tpu/ops/pallas``."""


def plain_versions():
    """``(module, name)`` of every plain version that an entry point runs
    in place of a kernel on a CPU tensor or another dtype: the wrappers'
    plain versions and the names the entry points bind to plain paths (and
    the blocked K1's, which no entry runs).  On a float32 CUDA tensor none
    of them may run; the card's robustness checks replace each by a
    function that fails."""
    from svdsolver_tpu_torch.models import (complex_svd, diagonalize, sbr, svd, tiled,
                                           two_stage, vectors)
    from svdsolver_tpu_torch.ops.cuda import (band_chase, band_chase_vmem, band_chase_wave,
                                              bisect, panel_qr, tridiag_solve)

    return (
        (panel_qr, "panel_qr_plain"),
        (panel_qr, "panel_qr_blocked_plain"),
        (panel_qr, "update_plain"),
        (panel_qr, "merge_plain"),
        (panel_qr, "merge_gram_plain"),
        (band_chase, "band_to_bidiagonal_plain"),
        (band_chase, "band_to_bidiagonal_accum_plain"),
        (band_chase, "superstep_plain"),
        (band_chase_wave, "_plain"),
        (band_chase_vmem, "band_to_bidiagonal_vmem_plain"),
        (bisect, "bisect_svdvals_plain"),
        (bisect, "bisect_svdvals_tree_plain"),
        (tridiag_solve, "tgk_solve_plain"),
        (tridiag_solve, "tgk_solve_staged_plain"),
        (tiled, "_factor_slab"),
        (tiled, "chain_plain"),
        (tiled, "apply_plain"),
        (tiled, "dense_to_band_tiled_plain"),
        (diagonalize, "bidiagonal_svdvals_plain"),
        (diagonalize, "convergence_threshold_plain"),
        (diagonalize, "shifted_sweep_plain"),
        (diagonalize, "zero_shift_sweep_plain"),
        (diagonalize, "dqds_svdvals_plain"),
        (diagonalize, "bisect_svdvals"),
        (two_stage, "dense_to_band_rec"),
        (two_stage, "dense_to_band_uv"),
        (two_stage, "band_to_bidiagonal"),
        (two_stage, "band_to_bidiagonal_accum"),
        (svd, "dense_to_band"),
        (svd, "dense_to_band_tiled_plain"),
        (svd, "band_to_bidiagonal"),
        (svd, "bisect_svdvals"),
        (vectors, "bisect_svdvals"),
        (complex_svd, "bisect_svdvals"),
        (sbr, "band_to_bidiagonal"),
    )
