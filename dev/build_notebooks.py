"""Build and execute the docs/demos tutorial notebooks.

Feature parity with the reference's 5 tutorial notebooks
(reference ``docs/demos/*.ipynb``: overview, from_stim_to_tsim,
magic_state_distillation, encoding_demo, global_rotations_qec_codes) —
content authored for this framework, executed for real on CPU.

    python dev/build_notebooks.py            # writes docs/demos/*.ipynb
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nbformat
from nbclient import NotebookClient

OUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs", "demos"
)


def md(source):
    return nbformat.v4.new_markdown_cell(source)


def code(source):
    return nbformat.v4.new_code_cell(source)


OVERVIEW = [
    md(
        "# tsim_tpu overview\n\n"
        "`tsim_tpu` samples measurements, detectors, and exact outcome\n"
        "probabilities from *noisy non-Clifford* stabilizer circuits, on\n"
        "GPUs. Circuits are written in Stim's program-text dialect\n"
        "(plus parametric rotations); compilation runs a ZX-calculus\n"
        "stabilizer-rank decomposition and emits static-shape binary\n"
        "tensors that the device evaluates per shot."
    ),
    code(
        "import numpy as np\n"
        "import tsim_tpu\n\n"
        "c = tsim_tpu.Circuit(\"\"\"\n"
        "    R 0 1\n"
        "    H 0\n"
        "    T 0\n"
        "    CNOT 0 1\n"
        "    DEPOLARIZE1(0.01) 0 1\n"
        "    M 0 1\n"
        "\"\"\")\n"
        "c"
    ),
    md(
        "## Measurement sampling\n\n"
        "`compile_sampler()` returns a compiled measurement sampler; noise\n"
        "is sampled on device and every shot evaluates the compiled\n"
        "stabilizer-term tensors exactly."
    ),
    code(
        "sampler = c.compile_sampler(seed=0)\n"
        "m = sampler.sample(20_000, batch_size=20_000)\n"
        "m.mean(axis=0)  # both qubits correlated, ~50/50 plus noise"
    ),
    md(
        "## Detectors and observables\n\n"
        "DETECTOR/OBSERVABLE_INCLUDE annotations work exactly as in Stim."
    ),
    code(
        "qec = tsim_tpu.Circuit(\"\"\"\n"
        "    R 0 1 2\n"
        "    X_ERROR(0.05) 0 1 2\n"
        "    M 0 1 2\n"
        "    DETECTOR rec[-3] rec[-2]\n"
        "    DETECTOR rec[-2] rec[-1]\n"
        "    OBSERVABLE_INCLUDE(0) rec[-1]\n"
        "\"\"\")\n"
        "det, obs = qec.compile_detector_sampler(seed=1).sample(\n"
        "    50_000, separate_observables=True)\n"
        "det.mean(axis=0), obs.mean()  # ~2p(1-p) each detector"
    ),
    md(
        "## Exact outcome probabilities\n\n"
        "`compile_state_probs()` evaluates exact joint outcome\n"
        "probabilities — the test suite checks these against a dense\n"
        "statevector oracle on random non-Clifford circuits."
    ),
    code(
        "probs = c.compile_state_probs(seed=0)\n"
        "{f'{a}{b}': float(np.mean(probs.probability_of(\n"
        "     np.array([a, b], dtype=np.uint8), batch_size=512)))\n"
        " for a in (0, 1) for b in (0, 1)}"
    ),
    md(
        "## Scaling out\n\n"
        "Every compiled sampler accepts `mesh=jax.sharding.Mesh(...)`; the\n"
        "shot axis shards across devices via `shard_map`, with per-device\n"
        "RNG fold-in and a `pmax` norm monitor over the mesh. See\n"
        "`docs/benchmarks.md` for the benchmark workloads."
    ),
]


FROM_STIM = [
    md(
        "# From Stim to tsim_tpu\n\n"
        "`tsim_tpu.Circuit` accepts Stim program text directly — the same\n"
        "gates, targets (`rec[-k]`, Pauli targets, combiners), REPEAT\n"
        "blocks, noise channels, and annotations. The difference:\n"
        "tsim_tpu also simulates *non-Clifford* gates (`T`, `R_Z(angle)`,\n"
        "…) under noise, which Stim cannot."
    ),
    code(
        "import numpy as np\n"
        "import tsim_tpu\n\n"
        "c = tsim_tpu.Circuit(\"\"\"\n"
        "    R 0 1\n"
        "    H 0\n"
        "    REPEAT 3 {\n"
        "        CNOT 0 1\n"
        "        DEPOLARIZE2(0.002) 0 1\n"
        "    }\n"
        "    MPP X0*X1\n"
        "    M 0 1\n"
        "\"\"\")\n"
        "c.num_measurements, c.num_qubits"
    ),
    md(
        "## Clifford circuits round-trip to Stim\n\n"
        "`cast_to_stim()` converts any Clifford tsim_tpu circuit to the\n"
        "in-house Stim-core circuit object (same text format), and\n"
        "`is_clifford` reports whether that's possible."
    ),
    code(
        "print(c.is_clifford)\n"
        "stim_circ = c.cast_to_stim()\n"
        "print(type(stim_circ).__name__)\n"
        "print(str(stim_circ).splitlines()[:4])"
    ),
    md(
        "## Beyond Stim: parametric rotations\n\n"
        "`R_Z(t) / R_X(t) / R_Y(t)` take the rotation in units of pi.\n"
        "Clifford angles (multiples of 1/2) expand to Clifford gates;\n"
        "anything else enters the stabilizer-rank pipeline."
    ),
    code(
        "nc = tsim_tpu.Circuit(\"\"\"\n"
        "    R 0\n"
        "    H 0\n"
        "    R_Z(0.17) 0\n"
        "    DEPOLARIZE1(0.01) 0\n"
        "    H 0\n"
        "    M 0\n"
        "\"\"\")\n"
        "print(nc.is_clifford, nc.tcount)\n"
        "m = nc.compile_sampler(seed=0).sample(50_000, batch_size=50_000)\n"
        "print('P(1) =', m.mean(), ' ideal =', round(float(np.sin(0.17*np.pi/2)**2), 4))"
    ),
    md(
        "## Detector error models and m2d\n\n"
        "`detector_error_model()` builds a DEM (with gauge detection and\n"
        "`approximate_disjoint_errors`, matching Stim's semantics) for the\n"
        "Clifford part of a circuit; `compile_m2d_converter()` converts\n"
        "measurement records to detection events."
    ),
    code(
        "qec = tsim_tpu.Circuit(\"\"\"\n"
        "    R 0 1 2\n"
        "    X_ERROR(0.05) 0 1 2\n"
        "    M 0 1 2\n"
        "    DETECTOR rec[-3] rec[-2]\n"
        "    DETECTOR rec[-2] rec[-1]\n"
        "    OBSERVABLE_INCLUDE(0) rec[-1]\n"
        "\"\"\")\n"
        "dem = qec.detector_error_model(\n"
        "    decompose_errors=True, allow_non_deterministic_observables=False)\n"
        "print(dem)"
    ),
    code(
        "m2d = qec.compile_m2d_converter()\n"
        "meas = qec.compile_sampler(seed=3).sample(8, batch_size=8)\n"
        "dets = m2d.convert(measurements=meas, separate_observables=False)\n"
        "dets.astype(int)"
    ),
]


DISTILLATION = [
    md(
        "# Magic state distillation\n\n"
        "Prepare noisy approximate T states, run 5-to-1 distillation, and\n"
        "measure the distilled infidelity with post-selection. The input\n"
        "is `T_DAG . R_X(theta*) |0>` with theta* = -arccos(sqrt(1/3))/pi."
    ),
    code(
        "import numpy as np\n"
        "import tsim_tpu\n\n"
        "theta = -np.arccos(np.sqrt(1 / 3)) / np.pi\n"
        "p = 0.05\n"
        "one = tsim_tpu.Circuit(f\"\"\"\n"
        "    R 0\n"
        "    R_X({theta}) 0\n"
        "    T_DAG 0\n"
        "    DEPOLARIZE1({p}) 0\n"
        "    T 0\n"
        "    R_X({-theta}) 0\n"
        "    M 0\n"
        "\"\"\")\n"
        "m = one.compile_sampler(seed=0).sample(100_000, batch_size=100_000)\n"
        "print('single-state infidelity:', m.mean(), ' ~ 2p/3 =', round(2*p/3, 4))"
    ),
    md(
        "## Logical 5-qubit distillation\n\n"
        "Five noisy magic states in, one distilled state out; the syndrome\n"
        "pattern `[1, 0, 1, 1]` selects the accept branch and drives the\n"
        "error from O(p) to 35 p^3."
    ),
    code(
        "from tsim_tpu.models.distillation import logical_distillation_circuit\n\n"
        "c = logical_distillation_circuit(p=p, noise=0.0)\n"
        "s = c.compile_sampler(seed=0).sample(50_000, batch_size=16_384)\n"
        "sel = np.all(s[:, 1:] == np.array([1, 0, 1, 1]), axis=1)\n"
        "print('post-selection rate:', sel.mean())\n"
        "print('distilled infidelity:', s[sel, 0].mean(), ' ~ 35p^3 =', round(35*p**3, 4))"
    ),
    md(
        "## Encoded d=3 distillation (35 qubits)\n\n"
        "The same protocol Steane-encoded ([[7,1,3]] per logical qubit) —\n"
        "the headline benchmark workload. Detectors check every stabilizer\n"
        "generator; post-select on all-quiet."
    ),
    code(
        "from tsim_tpu.models.distillation import distillation_d3\n\n"
        "enc = distillation_d3(p=p, basis='Z')\n"
        "sampler = enc.compile_detector_sampler(seed=42)\n"
        "det, obs = sampler.sample(20_000, separate_observables=True)\n"
        "keep = ~det.any(axis=1)\n"
        "acc = np.all(obs[keep][:, 1:] == np.array([1, 0, 1, 1]), axis=1)\n"
        "print('kept:', keep.mean(), ' accept:', acc.mean())"
    ),
    md(
        "Repeating with `basis='X'` / `basis='Y'` reconstructs the\n"
        "distilled density matrix by tomography; `distillation_d5` is the\n"
        "85-qubit [[17,1,5]] color-code variant with the same interface."
    ),
]


ENCODING = [
    md(
        "# Encoding logical circuits\n\n"
        "`tsim_tpu.utils.encoder` rewrites a *logical* program into an\n"
        "*encoded physical* circuit by broadcasting each logical operation\n"
        "across code blocks — the mechanism behind the 35- and 85-qubit\n"
        "distillation models. Logical qubit `q` maps to the physical block\n"
        "`[q*n, (q+1)*n)`."
    ),
    code(
        "import numpy as np\n"
        "import tsim_tpu\n"
        "from tsim_tpu.utils.encoder import SteaneEncoder, ColorEncoder5\n\n"
        "enc = SteaneEncoder()                  # [[7,1,3]]\n"
        "enc.initialize('R 0\\nH 0\\nT 0\\n')   # logical |H_XY> injection\n"
        "enc.encode_transversally('CNOT 0 1\\nM 1\\n')\n"
        "physical = enc.circuit\n"
        "physical.num_qubits"
    ),
    md(
        "`initialize` prepares each logical qubit on one slot per block and\n"
        "appends the code's encoding circuit on every used block;\n"
        "`encode_transversally` broadcasts instructions across all `n`\n"
        "physical qubits, rewriting DETECTOR / OBSERVABLE_INCLUDE per\n"
        "stabilizer generator / logical support."
    ),
    code(
        "enc2 = SteaneEncoder()\n"
        "enc2.initialize('R 0')\n"
        "enc2.encode_transversally(\"\"\"\n"
        "    M 0\n"
        "    DETECTOR rec[-1]\n"
        "    OBSERVABLE_INCLUDE(0) rec[-1]\n"
        "\"\"\")\n"
        "c = enc2.circuit\n"
        "det, obs = c.compile_detector_sampler(seed=0).sample(\n"
        "    4_096, separate_observables=True)\n"
        "print('noiseless encoded block: detectors silent =', not det.any(),\n"
        "      ' observable =', obs.mean())"
    ),
    md(
        "## Defining your own code\n\n"
        "`TransversalEncoder` takes a `CodeSpec`: block size, the in-block\n"
        "slot receiving the unencoded state, the encoding circuit text, and\n"
        "the stabilizer / logical-support fanouts for annotations."
    ),
    code(
        "from tsim_tpu.utils.encoder import CodeSpec, TransversalEncoder\n\n"
        "# Trivial 3-qubit repetition code (Z-type), for illustration.\n"
        "rep3 = CodeSpec(\n"
        "    block_size=3,\n"
        "    injection_slot=0,\n"
        "    encoding_text='CNOT 0 1 0 2\\n',\n"
        "    stabilizers=((0, 1), (1, 2)),\n"
        "    logical_supports=((0, 1, 2),),\n"
        ")\n"
        "enc3 = TransversalEncoder(rep3)\n"
        "enc3.initialize('R 0\\nX 0')\n"
        "enc3.encode_transversally('M 0\\nOBSERVABLE_INCLUDE(0) rec[-1]\\n')\n"
        "m, = enc3.circuit.compile_sampler(seed=0).sample(1).tolist()\n"
        "m  # all three physical qubits flipped"
    ),
    md(
        "Transversal `T`/`T_DAG` on the built-in codes implements the\n"
        "logical non-Clifford gates used by distillation; `ColorEncoder5`\n"
        "([[17,1,5]], block size 17) provides the d=5 variant."
    ),
]


QEC_ROTATIONS = [
    md(
        "# Global rotations in QEC codes\n\n"
        "A coherent Z-rotation on every data qubit is the textbook\n"
        "non-Pauli noise model that Pauli-twirling simulators cannot\n"
        "represent. tsim_tpu simulates it exactly: `R_Z(t)` gates enter\n"
        "the stabilizer-rank pipeline like any other non-Clifford gate."
    ),
    code(
        "import numpy as np\n"
        "import tsim_tpu\n"
        "from tsim_tpu.models.surface_code import rotated_surface_code_memory_z\n\n"
        "mem = rotated_surface_code_memory_z(distance=3, rounds=2,\n"
        "                                    after_clifford_depolarization=0.01)\n"
        "mem.num_qubits, mem.num_detectors"
    ),
    md(
        "## Injecting a coherent global rotation\n\n"
        "Insert `R_Z(t)` on all data qubits after the first round. For\n"
        "small t the induced detector activity scales as sin^2(pi t / 2)\n"
        "per qubit — a *coherent* error channel."
    ),
    code(
        "def with_global_rz(t, d=3):\n"
        "    base = str(rotated_surface_code_memory_z(distance=d, rounds=1))\n"
        "    lines = base.splitlines()\n"
        "    # data qubits are 0..d*d-1; inject after the reset line\n"
        "    data = ' '.join(str(q) for q in range(d * d))\n"
        "    out = []\n"
        "    injected = False\n"
        "    for ln in lines:\n"
        "        out.append(ln)\n"
        "        if not injected and ln.strip().startswith('R '):\n"
        "            out.append(f'R_Z({t}) {data}')\n"
        "            injected = True\n"
        "    return tsim_tpu.Circuit('\\n'.join(out))\n\n"
        "c = with_global_rz(0.1)\n"
        "print('T-count equivalent:', c.tcount, ' clifford:', c.is_clifford)"
    ),
    code(
        "dets = {}\n"
        "for t in (0.0, 0.05, 0.1):\n"
        "    det = with_global_rz(t).compile_detector_sampler(seed=0).sample(4_096)\n"
        "    dets[t] = det.mean()\n"
        "dets  # detector fraction grows with the coherent angle"
    ),
    md(
        "## Why this matters\n\n"
        "Coherent errors interfere across rounds and qubits; their logical\n"
        "effect differs from the Pauli-twirled approximation. Because every\n"
        "shot here is drawn from the *exact* distribution, threshold and\n"
        "pseudo-threshold studies under coherent noise need no twirling\n"
        "assumption. The magic-state cultivation model\n"
        "(`models.cultivation`) pushes the same machinery much harder —\n"
        "see `docs/tutorial_cultivation.md`."
    ),
    code(
        "from tsim_tpu.models.cultivation import cultivation_logical\n\n"
        "c = cultivation_logical(p=0.02, checks=1)\n"
        "det, obs = c.compile_detector_sampler(seed=0).sample(\n"
        "    100_000, separate_observables=True)\n"
        "keep = ~det[:, 0]\n"
        "print('check pass rate:', keep.mean())\n"
        "print('X-readout mean:', obs[keep, 0].mean(),\n"
        "      ' ideal (1-1/sqrt2)/2 =', round((1 - 2**-0.5) / 2, 4))"
    ),
]


NOTEBOOKS = {
    "overview.ipynb": OVERVIEW,
    "from_stim_to_tsim.ipynb": FROM_STIM,
    "magic_state_distillation.ipynb": DISTILLATION,
    "encoding_demo.ipynb": ENCODING,
    "global_rotations_qec_codes.ipynb": QEC_ROTATIONS,
}


def build(name: str, cells) -> None:
    nb = nbformat.v4.new_notebook()
    nb.cells = list(cells)
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3",
        "language": "python",
        "name": "python3",
    }
    client = NotebookClient(nb, timeout=1200, kernel_name="python3")
    client.execute()
    path = os.path.join(OUT_DIR, name)
    nbformat.write(nb, path)
    print(f"wrote {path}")


def main() -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    only = sys.argv[1:] or list(NOTEBOOKS)
    for name in only:
        build(name, NOTEBOOKS[name])


if __name__ == "__main__":
    main()
