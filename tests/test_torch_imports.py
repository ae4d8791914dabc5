"""The port imports neither JAX nor ``coma_tpu``, nor Flax, optax,
``safetensors``, PIL, OpenCV or matplotlib (the card machine has none).

The in-process check proves nothing (``tests/conftest.py`` imports JAX), so
the package and its CLIs are imported in a fresh interpreter; an AST scan
covers every module, including those the import does not reach.
"""
import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "coma_tpu", "flax", "optax", "safetensors", "PIL", "cv2",
             "matplotlib")


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_in_fresh_interpreter_loads_no_jax():
    code = (
        "import sys\n"
        "import coma_tpu_torch, coma_tpu_torch.cli.extract_coma, coma_tpu_torch.cli.inference\n"
        "import coma_tpu_torch.ops.contact_kernel, coma_tpu_torch.ops.occupancy_kernel\n"
        "import coma_tpu_torch.ops.attention, coma_tpu_torch.cli.inpaint\n"
        "import coma_tpu_torch.models.diffusion.pipeline, coma_tpu_torch.models.diffusion.unet\n"
        "import coma_tpu_torch.models.diffusion.vae, coma_tpu_torch.models.diffusion.clip_text\n"
        "import coma_tpu_torch.models.segmentation, coma_tpu_torch.models.flax_params\n"
        "import coma_tpu_torch.utils.png, coma_tpu_torch.utils.checkpoint\n"
        "import coma_tpu_torch.cli.learn_coma, coma_tpu_torch.cli.filter\n"
        "import coma_tpu_torch.cli.downsample_human, coma_tpu_torch.cli.downsample_objects\n"
        "import coma_tpu_torch.parallel.distributed, coma_tpu_torch.models.smplx\n"
        "import coma_tpu_torch.native, coma_tpu_torch.geometry.sampling\n"
        "import coma_tpu_torch.pipelines.downsample, coma_tpu_torch.pipelines.postfilter\n"
        "import coma_tpu_torch.affordance.evaluation, coma_tpu_torch.config.assets\n"
        "import coma_tpu_torch.models.keypoints, coma_tpu_torch.models.vposer\n"
        "import coma_tpu_torch.models.coap, coma_tpu_torch.models.coap_partition\n"
        "import coma_tpu_torch.pipelines.application, coma_tpu_torch.cli.optimize\n"
        "import coma_tpu_torch.models.diffusion.tokenizer\n"
        "import coma_tpu_torch.models.diffusion.weights\n"
        "import coma_tpu_torch.ops.sampling, coma_tpu_torch.models.pointrend\n"
        "import coma_tpu_torch.models.sam, coma_tpu_torch.models.segmenter_weights\n"
        "import coma_tpu_torch.models.mask_predictors, coma_tpu_torch.config.segmentation\n"
        "import coma_tpu_torch.cli.segment_human, coma_tpu_torch.visualization.video\n"
        "import coma_tpu_torch.utils.gif\n"
        "import coma_tpu_torch.lifting.cameras, coma_tpu_torch.lifting.rasterizer\n"
        "import coma_tpu_torch.lifting.depth_init, coma_tpu_torch.lifting.triangulation\n"
        "import coma_tpu_torch.lifting.depth_optimize, coma_tpu_torch.lifting.metrics\n"
        "import coma_tpu_torch.ops.collision, coma_tpu_torch.models.resnet\n"
        "import coma_tpu_torch.models.hand4whole, coma_tpu_torch.pipelines.mocap\n"
        "import coma_tpu_torch.pipelines.postprocess, coma_tpu_torch.pipelines.asset_world\n"
        "import coma_tpu_torch.optim, coma_tpu_torch.cli.predict_human\n"
        "import coma_tpu_torch.cli.initialize_depth, coma_tpu_torch.cli.optimize_depth\n"
        "import coma_tpu_torch.cli.compute_metrics, coma_tpu_torch.cli.generate_3d_hoi_samples\n"
        "import coma_tpu_torch.utils.resize, coma_tpu_torch.geometry.polygon\n"
        "import coma_tpu_torch.pipelines.rendering, coma_tpu_torch.pipelines.mask_select\n"
        "import coma_tpu_torch.pipelines.canonicalize_assets, coma_tpu_torch.cli.render_objects\n"
        "import coma_tpu_torch.cli.select_mask, coma_tpu_torch.cli.generate_prompts\n"
        "import coma_tpu_torch.cli.generate_2d_hoi_images\n"
        "import coma_tpu_torch.cli.evaluate, coma_tpu_torch.cli.visualize\n"
        "import coma_tpu_torch.cli.train_segmenter, coma_tpu_torch.pipelines.behave_eval\n"
        "import coma_tpu_torch.visualization.viz, coma_tpu_torch.visualization.volume\n"
        "import coma_tpu_torch.visualization.contact_viz, coma_tpu_torch.geometry.correspondence\n"
        "import coma_tpu_torch.models.synthetic_person, coma_tpu_torch.models.segmentation_train\n"
        "import coma_tpu_torch.config.filtering, coma_tpu_torch.utils.ids\n"
        "import coma_tpu_torch.utils.profiling, coma_tpu_torch.utils.jpeg\n"
        "import coma_tpu_torch.__main__\n"
        "import coma_tpu_torch.parallel, coma_tpu_torch.parallel.flagship\n"
        "import coma_tpu_torch.parallel.sharding, coma_tpu_torch.geometry.transforms\n"
        "import coma_tpu_torch.models.weights_readiness, coma_tpu_torch.cli.convert_weights\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tools')!r})\n"
        "import phase15_torch\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'coma_tpu_torch.cli.extract_coma' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.inpaint' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.learn_coma' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.optimize' in sys.modules\n"
        "assert 'coma_tpu_torch.models.diffusion.weights' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.segment_human' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.generate_3d_hoi_samples' in sys.modules\n"
        "assert 'coma_tpu_torch.lifting.rasterizer' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.generate_2d_hoi_images' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.train_segmenter' in sys.modules\n"
        "assert 'coma_tpu_torch.visualization.volume' in sys.modules\n"
        "assert 'coma_tpu_torch.parallel.sharding' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.convert_weights' in sys.modules\n"
        "assert 'chip_smoke' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_no_module_of_the_port_imports_jax_or_coma_tpu():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "profile_inpaint_torch.py"),
             os.path.join(REPO, "tools", "stage2_torch.py"),
             os.path.join(REPO, "tools", "stage1_torch.py"),
             os.path.join(REPO, "tools", "item14_torch.py"),
             os.path.join(REPO, "tools", "phase15_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "coma_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for name in ("utils/resize.py", "geometry/polygon.py", "pipelines/rendering.py",
                 "pipelines/mask_select.py", "pipelines/canonicalize_assets.py",
                 "cli/render_objects.py", "cli/select_mask.py", "cli/generate_prompts.py",
                 "cli/generate_2d_hoi_images.py", "cli/evaluate.py", "cli/visualize.py",
                 "cli/train_segmenter.py", "pipelines/behave_eval.py", "visualization/viz.py",
                 "visualization/volume.py", "visualization/contact_viz.py",
                 "geometry/correspondence.py", "models/synthetic_person.py",
                 "models/segmentation_train.py", "config/filtering.py", "utils/ids.py",
                 "utils/profiling.py", "utils/jpeg.py", "__main__.py", "parallel/flagship.py",
                 "parallel/sharding.py", "models/weights_readiness.py",
                 "cli/convert_weights.py"):
        assert os.path.join(REPO, "coma_tpu_torch", name) in files, name
    offenders = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [(path, n) for n in names if _forbidden(n)]
    assert not offenders, offenders
