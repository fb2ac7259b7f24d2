"""What the benchmark loads: no JAX and no JAX package (``ray_tpu``) where it
measures, compared by whole top-level name; nothing of the port in the plain
reference."""
import subprocess
import sys

import pytest

from perfbench import harness

REPO = str(harness.REPO)


def _loaded(code):
    probe = f"import sys; sys.path.insert(0, {REPO!r}); {code}; print(sorted({{m.split('.')[0] for m in sys.modules}}))"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    return eval(out.stdout.strip().splitlines()[-1])


def test_reference_imports_neither_jax_nor_either_package():
    tops = _loaded("import perfbench.reference.mistral, perfbench.reference.plain")
    assert not {"jax", "jaxlib", "flax", "ray_tpu", "ray_tpu_torch"} & set(tops)


def test_harness_entries_and_readers_import_no_jax_and_no_ray_tpu():
    code = ("import perfbench.run, perfbench.control, perfbench.sweep, perfbench.faults, perfbench.check; "
            "from perfbench import harness; "
            "[__import__('perfbench.entries.' + e, fromlist=['Entry']) for e in "
            "('serve_stream', 'engine_backlog', 'train_step')]; "
            "[harness.load_cell(w['name']).model() for w in harness.manifest()['workloads']]; "
            "[harness.metric_reader(m['name']) for m in harness.manifest()['per_layer'] + "
            "harness.manifest()['end_to_end']]; "
            "import ray_tpu_torch.llm.deployment, ray_tpu_torch.llm.engine, ray_tpu_torch.models.transformer")
    tops = set(_loaded(code))
    assert "ray_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "ray_tpu"} & tops


@pytest.mark.parametrize("modules,found", [
    (["ray_tpu_torch", "ray_tpu_torch.llm"], []),
    (["ray_tpu.models", "numpy"], ["ray_tpu"]),
    (["jax._src.core", "jaxlib"], ["jax", "jaxlib"]),
    (["flaxen", "jaxtyping"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    assert harness.forbidden_loaded(modules) == found


def test_run_exits_without_a_result_where_no_card_is_visible():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "train.lm250m.s2048", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=REPO, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
