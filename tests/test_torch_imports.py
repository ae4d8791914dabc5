"""The port imports neither JAX nor ``coma_tpu``, nor Flax, optax,
``safetensors`` or PIL (the card machine has none).

The in-process check proves nothing (``tests/conftest.py`` imports JAX), so
the package and its CLIs are imported in a fresh interpreter; an AST scan
covers every module, including those the import does not reach.
"""
import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "coma_tpu", "flax", "optax", "safetensors", "PIL")


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
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'coma_tpu_torch.cli.extract_coma' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.inpaint' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.learn_coma' in sys.modules\n"
        "assert 'coma_tpu_torch.cli.optimize' in sys.modules\n"
        "assert 'coma_tpu_torch.models.diffusion.weights' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_no_module_of_the_port_imports_jax_or_coma_tpu():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "profile_inpaint_torch.py")]
    for root, _, names in os.walk(os.path.join(REPO, "coma_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
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
