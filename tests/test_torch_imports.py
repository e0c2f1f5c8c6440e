"""Import hygiene of the port: aimet_tpu_torch and chip_smoke.py import
neither JAX/flax nor anything of aimet_tpu, and importing the port leaves
jax out of sys.modules."""
import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "aimet_tpu")


def _files():
    return sorted((ROOT / "aimet_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_native_scheduler_source_includes_only_the_standard_library():
    src = (ROOT / "aimet_tpu_torch" / "native" / "src" / "scheduler.cpp")
    includes = [line.split()[1] for line in src.read_text().splitlines()
                if line.startswith("#include")]
    assert includes and all(i.startswith("<") for i in includes), includes


def test_encoding_search_source_includes_only_the_standard_library():
    src = (ROOT / "aimet_tpu_torch" / "native" / "src" /
           "encoding_search.cpp")
    includes = [line.split()[1] for line in src.read_text().splitlines()
                if line.startswith("#include")]
    assert includes and all(i.startswith("<") for i in includes), includes


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _files(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    names = list(_imported(ast.parse(path.read_text())))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, (path, bad)


def test_importing_port_leaves_jax_unloaded():
    code = ("import sys, aimet_tpu_torch, aimet_tpu_torch.convert; "
            "import aimet_tpu_torch.ops.decode_attention_fused; "
            "import aimet_tpu_torch.ops.fused_layer; "
            "import aimet_tpu_torch.ops.decode_layer_sol; "
            "import aimet_tpu_torch.ops.decode_attention; "
            "import aimet_tpu_torch.quantsim.lowering; "
            "import aimet_tpu_torch.quantsim.qsim; "
            "import aimet_tpu_torch.quantization.encoding_analyzer; "
            "import aimet_tpu_torch.ops.int_conv, aimet_tpu_torch.ops.requant; "
            "import aimet_tpu_torch.models.resnet; "
            "import aimet_tpu_torch.models.mobilenet_v2; "
            "import aimet_tpu_torch.native, aimet_tpu_torch.models; "
            "import aimet_tpu_torch.serving.batcher; "
            "import aimet_tpu_torch.algorithms, aimet_tpu_torch.utils.pytree; "
            "import aimet_tpu_torch.quantization.float_sim; "
            "import aimet_tpu_torch.quantization.grads; "
            "import aimet_tpu_torch.quantization.blockwise; "
            "import aimet_tpu_torch.utils.logger; "
            "import aimet_tpu_torch.algorithms.bn_reestimation; "
            "import aimet_tpu_torch.algorithms.quant_analyzer; "
            "import aimet_tpu_torch.algorithms.smooth_quant; "
            "import aimet_tpu_torch.algorithms.gptq; "
            "import aimet_tpu_torch.algorithms.kd; "
            "import aimet_tpu_torch.utils.cache; "
            "import aimet_tpu_torch.algorithms.amp; "
            "import aimet_tpu_torch.algorithms.auto_quant; "
            "import aimet_tpu_torch.algorithms.peft; "
            "import aimet_tpu_torch.graph.pattern_matcher; "
            "import aimet_tpu_torch.algorithms.arch_checker; "
            "import aimet_tpu_torch.quantsim.backend_aware; "
            "import aimet_tpu_torch.quantsim.legacy; "
            "import aimet_tpu_torch.utils.weight_padding; "
            "import aimet_tpu_torch.utils.layer_output; "
            "import aimet_tpu_torch.utils.visualization; "
            "import aimet_tpu_torch.graph.control_flow; "
            "import aimet_tpu_torch.quantsim.recurrent; "
            "import aimet_tpu_torch.models.deepspeech; "
            "import aimet_tpu_torch.models.cnn; "
            "import aimet_tpu_torch.compression; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'aimet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
