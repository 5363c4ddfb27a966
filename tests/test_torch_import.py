"""The PyTorch port imports neither JAX nor the JAX package, and its kernels
build lazily."""

import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# an import of the JAX package itself (not of ucoslam_tpu_torch)
IMPORTS_JAX_PACKAGE = re.compile(r"^\s*(import ucoslam_tpu\b|from ucoslam_tpu(\.| import))", re.M)


def test_port_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import ucoslam_tpu_torch, ucoslam_tpu_torch.api, ucoslam_tpu_torch.io.synthetic\n"
        "import ucoslam_tpu_torch.ops.cuda.match_kernel, ucoslam_tpu_torch.ops.cuda.lm_kernel\n"
        "import ucoslam_tpu_torch.markers.dictionary, ucoslam_tpu_torch.markers.native\n"
        "import ucoslam_tpu_torch.markers.ippe, ucoslam_tpu_torch.markers.detector, ucoslam_tpu_torch.slam.markermap\n"
        "import ucoslam_tpu_torch.io.stereorectify, ucoslam_tpu_torch.features.frame_extractor\n"
        "import ucoslam_tpu_torch.io.fbow, ucoslam_tpu_torch.optim.schur_pm, ucoslam_tpu_torch.slam.system\n"
        "import ucoslam_tpu_torch.io.png, ucoslam_tpu_torch.io.datasets, ucoslam_tpu_torch.io.exporters\n"
        "import ucoslam_tpu_torch.utils.timers, ucoslam_tpu_torch.utils.hostbuild, ucoslam_tpu_torch.viz.viewer\n"
        "from ucoslam_tpu_torch.apps import analyze_logs, compare_logs, map_export, run_slam\n"
        "from ucoslam_tpu_torch.apps import stereo_rectify, test_reloc, test_sequence, bench_scaling\n"
        "import ucoslam_tpu_torch.parallel, ucoslam_tpu_torch.parallel.sharded_pm, ucoslam_tpu_torch.markers.predefined\n"
        "import tools.port.parallel_tasks, tools.port.marker_render\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'ucoslam_tpu' not in sys.modules, 'ucoslam_tpu imported'\n"
        "from ucoslam_tpu_torch.ops import cuda\n"
        "assert cuda.load_library.cache_info().currsize == 0, 'a kernel was built at import'\n"
        "from ucoslam_tpu_torch.markers import native\n"
        "assert native.load_library.cache_info().currsize == 0, 'the marker detector was built at import'\n"
        "from ucoslam_tpu_torch.io import png\n"
        "assert png._library.cache_info().currsize == 0, 'the PNG helper was built at import'\n"
        "assert 'cv2' not in sys.modules, 'cv2 imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "ucoslam_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")] + [os.path.join(REPO, "tools", "port", name)
                                                    for name in ("parallel_tasks.py", "marker_render.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, name) for name in files if name.endswith(".py")]
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert "import jax" not in src and "from jax" not in src, path
        assert not IMPORTS_JAX_PACKAGE.search(src), path


def test_jax_package_import_pattern():
    for line in ("import ucoslam_tpu", "from ucoslam_tpu.config import Params",
                 "from ucoslam_tpu import config", "    import ucoslam_tpu.ops"):
        assert IMPORTS_JAX_PACKAGE.search(line), line
    for line in ("import ucoslam_tpu_torch", "from ucoslam_tpu_torch.config import Params",
                 "from ucoslam_tpu_torch import Mode", "# see ucoslam_tpu.config"):
        assert not IMPORTS_JAX_PACKAGE.search(line), line
