"""What the benchmark loads: nothing of JAX or of the JAX package, and a
reference that loads nothing of the program.  Each check runs in a fresh
process, so that no other test's imports count."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _top_level_names(code: str) -> set:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_run_loads_no_jax():
    """run.py's imports, every traffic driver and metric reader, and the
    port's modules they call."""
    names = _top_level_names(
        "import sys; sys.path.insert(0, 'ovbench'); sys.argv = ['run.py']\n"
        "import runpy; runpy.run_path('ovbench/run.py', run_name='not_main')\n"
        "from ovbench import harness\n"
        "[harness.traffic(k) for k in ('train', 'detect')]\n"
        "b = harness.benchmark(); [harness.reader(m['name']) for m in b['per_layer']]\n"
        "import ov3det_torch.engine.train, ov3det_torch.engine.infer\n"
        "import ov3det_torch.datasets.loader, ov3det_torch.models.regionclip\n")
    assert "ov3det_torch" in names and "ovbench" in names
    assert not names & {"jax", "jaxlib", "flax", "ov3det"}, names & {"jax", "jaxlib", "flax", "ov3det"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level_names(
        "import ovbench.reference.detector, ovbench.reference.criterion\n"
        "import ovbench.reference.teacher, ovbench.reference.parse, ovbench.reference.step\n")
    assert not names & {"ov3det_torch", "ov3det", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_whole_top_level_names():
    from ovbench import harness

    sys.modules.setdefault("ov3det_torch", type(sys)("ov3det_torch"))
    assert "ov3det" not in [n for n in harness.forbidden_modules() if n == "ov3det_torch"]
    assert "ov3det_torch" not in harness.forbidden_modules()
