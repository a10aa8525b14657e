"""Properties of the PyTorch port as a whole: it (and ``chip_smoke.py``,
and the examples' twins under ``examples/torch/``) never imports JAX or
the JAX package, its kernel modules import without a
CUDA compiler, and ``chip_smoke.py`` refuses to report a result without a
CUDA device."""

import os
import re
import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "approximategps_tpu_torch"


def _run(code_or_args, env=None, cwd=REPO):
    args = code_or_args if isinstance(code_or_args, list) else [sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_torch_port_imports_no_jax():
    proc = _run(
        "import sys, approximategps_tpu_torch as t\n"
        "t.posterior, t.build_svgp, t.convert.from_jax_params\n"
        "t.NearestNeighbors, t.BandInvRoot, t.SparseInvRoot, t.approx_root_prec_band\n"
        "t.approx_root_prec_sparse, t.band_Ut_matmul, t.band_U_matvec, t.predict_knn\n"
        "t.knn_search, t.convert.build_vecchia_fx, t.ops.vecchia_band, t.ops.vecchia_band_t\n"
        "t.WhiteKernel, t.SumKernel, t.ConstantKernel, t.unwrap_stationary_nugget\n"
        "t.resolve_ordering, t.maximin_ordering, t.nearest_predecessor_neighbors\n"
        "t.scaled_ball_predecessors, t.convert.build_vecchia_nugget_fx, t.ops.vecchia_band_bwd\n"
        "t.ops.vecchia_band_bwd_pass, t.native.native_available\n"
        "t.RationalQuadraticKernel, t.PeriodicKernel, t.LinearKernel, t.PolynomialKernel\n"
        "t.ProductKernel, t.ops.batched_chol_solve_band, t.ops.batched_chol_solve_band_pass\n"
        "t.ops.stationary_gram, t.ops.stationary_gram_pass, t.ops.stationary_gram_plain\n"
        "t.ops.stationary_gram_bwd, t.convert.build_vecchia_rq_fx, t.convert.build_knn_hetero_fx\n"
        "t.BernoulliLikelihood, t.PoissonLikelihood, t.ExponentialLikelihood, t.GammaLikelihood\n"
        "t.NegativeBinomialLikelihood, t.GaussNewtonLikelihood, t.StudentTLikelihood\n"
        "t.FunctionLikelihood, t.Likelihood, t.as_likelihood, t.MonteCarlo, t.GaussHermite\n"
        "t.VFE, t.optimal_variational_posterior, t.vfe_elbo, t.BlockNearestNeighbors\n"
        "t.BlockInvRoot, t.block_vecchia_factors, t.natgrad_update, t.natgrad_update_tril\n"
        "t.make_natgrad_adam_step, t.lbfgs_fit, t.blocked_tril_inv, t.convert.natgrad_elbo\n"
        "t.convert.poisson_svgp_loss, t.core.linalg.cholesky_solve, t.core.linalg.add_jitter\n"
        "t.LaplaceApproximation, t.LaplacePosterior, t.LaplaceObjective, t.LaplaceResult\n"
        "t.newton_inner_loop, t.newton_inner_loop_jvp, t.newton_multistart, t.laplace_lml\n"
        "t.laplace_f_and_lml, t.laplace_f_cov, t.laplace_steps, t.laplace_steps_scan\n"
        "t.build_laplace_objective, t.LaplaceCG, t.LaplaceCGPosterior, t.laplace_lml_cg\n"
        "t.newton_inner_loop_cg, t.msqrt_matvec, t.sample_prior_msqrt, t.sample_posterior_msqrt\n"
        "t.convert.laplace_neg_lml, t.convert.laplace_kernel, t.convert.LAPLACE_CG_THETA, t.convert.laplace_data\n"
        "t.core.linalg.cholesky_or_nan, t.core.distributions.mvnormal_from_cov\n"
        "t.config.cg_dense_threshold\n"
        "t.rff_features, t.sample_svgp_functions, t.sample_posterior_functions_cg\n"
        "t.models.sampling.draw_rff, t.models.sampling.cg_pathwise, t.core.unwrap_spectral\n"
        "t.HeteroscedasticGaussianLikelihood, t.SoftmaxLikelihood, t.MultiLatentSVGP\n"
        "t.multi_latent_elbo, t.OnlineSVGPState, t.GaussianSiteState, t.online_elbo\n"
        "t.online_optimal_q, t.online_state, t.site_state, t.site_update, t.site_posterior_q\n"
        "t.loo_logpdf, t.loo_mean_and_var, t.DiagNormal, t.ScaleTransform, t.SVGP\n"
        "t.inducing_points, t.utils.positive, t.utils.fill_triangular_inverse\n"
        "t.utils.normal_prior, t.utils.map_objective, t.utils.save_checkpoint\n"
        "t.utils.AsyncCheckpointer, t.utils.minibatch_iterator, t.utils.StepTimer, t.utils.trace\n"
        "t.test_utils.generate_data, t.convert.heteroscedastic_svgp\n"
        "t.convert.heteroscedastic_loss\n"
        "t.parallel.data_mesh, t.parallel.shard_batch, t.parallel.replicated\n"
        "t.parallel.make_dp_elbo, t.parallel.make_dp_train_step, t.parallel.dp_predict_blocks\n"
        "t.parallel.DataMesh, t.dp_streaming_elbo, t.models.dp_streaming_elbo\n"
        "t.core.linalg.At_A, t.core.linalg.diag_At_A, t.core.linalg.Xt_invA_X\n"
        "t.core.linalg.diag_Xt_invA_X, t.core.linalg.blocked_cholesky, t.core.linalg.tri_project\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'approximategps_tpu' not in sys.modules\n"
    )
    assert proc.returncode == 0, proc.stderr
    sources = [p for p in PKG.rglob("*.py") if "_build" not in p.relative_to(PKG).parts]
    for path in sources + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            assert not re.match(r"\s*(import|from)\s+jax\b", line), (path, line)
            assert "torch.compile" not in line, (path, line)
            # nothing of the JAX package either, not even a module of it that
            # does not import JAX; the port's own name is allowed
            assert not re.match(r"\s*(import|from)\s+approximategps_tpu(?!_torch)\b", line), \
                (path, line)


def test_torch_example_twins_import_no_jax():
    """No file under examples/torch/ imports jax, optax or the JAX package,
    and importing every twin in a fresh process loads none of them."""
    twins = sorted((REPO / "examples" / "torch").glob("*.py"))
    assert len([p for p in twins if not p.name.startswith(("_", "run_"))]) == 10
    for path in twins:
        for line in path.read_text().splitlines():
            assert not re.match(r"\s*(import|from)\s+(jax|optax)\b", line), (path, line)
            assert not re.match(r"\s*(import|from)\s+approximategps_tpu(?!_torch)\b", line), \
                (path, line)
    proc = _run(
        "import sys\n"
        f"sys.path.insert(0, {str(REPO / 'examples' / 'torch')!r})\n"
        "import run_twins\n"
        "for name in run_twins.RUNS:\n"
        "    run_twins.load(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', "
        "'approximategps_tpu'))\n"
        "assert not bad, bad\n"
    )
    assert proc.returncode == 0, proc.stderr


def test_torch_kernel_modules_import_without_nvcc(tmp_path):
    """Importing the ops modules builds nothing; a first launch with no
    nvcc and no built library raises instead of falling back."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    proc = _run(
        "import approximategps_tpu_torch.ops as ops\n"
        "from approximategps_tpu_torch.ops import _build\n"
        "assert _build.load_library.cache_info().currsize == 0\n"
        "try:\n"
        "    _build._nvcc()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e)\n"
        "else:\n"
        "    raise SystemExit('nvcc was found')\n",
        env=env,
    )
    assert proc.returncode == 0, proc.stderr


def test_torch_chip_smoke_refuses_without_cuda():
    assert not torch.cuda.is_available()
    proc = _run([sys.executable, str(REPO / "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
