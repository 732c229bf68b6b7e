"""The reference's offline lowering engine, as far as it carries over.

Counterpart of ``mxnet_tpu/memory/lowering.py``, whose engine lowers a
JAX program ahead of time (``tools/scale_proof.py``) and harvests XLA's
memory analysis into the committed ``*_LOWER_*.json`` artifacts that the
planner's cold path reads back (``planner.plan_from_artifact``).  Two
functions work on dicts and text and are ported as they are:
:func:`fit_verdict` (an artifact's fit-verdict block) and
:func:`cpu_upcast_artifact_bytes` (the XLA:CPU bf16-upcast slots of a
dumped buffer assignment).  ``shell_params``, ``remat_forward`` and
``harvest_memory`` trace and compile XLA programs and have no
counterpart here: they raise ``MXNetError`` naming ROADMAP.md's "Not
carried over" (the port's planner is analytic; its fit on the card is
measured with the allocator's own figures).
"""
import glob
import os
import re

from .._left_out import refuse

#: the per-device budget (GiB) under which the JAX package's committed
#: TPU lowering artifacts were compiled; ``planner.plan_from_artifact``
#: judges a TPU artifact by it, never by this card's memory
TPU_BUDGET_GIB = 15.75

LAYER0_PREFIX = "model.layers.0."

__getattr__ = refuse(dict.fromkeys(
    ("shell_params", "remat_forward", "harvest_memory"),
    "Not carried over"), __name__)


def cpu_upcast_artifact_bytes(n_layers, dump_dir):
    """Sum the preallocated-temp slots that are f32 CONVERTS of bf16
    layer-stacked arrays (shape leading dim == n_layers, producer a
    convert fusion) in the dumped buffer assignment — the XLA:CPU
    bf16-dot upcast artifact quantified in the fit verdict.  Returns
    (bytes, [slot descriptions])."""
    files = glob.glob(os.path.join(dump_dir, "*buffer-assignment.txt"))
    if not files:
        return 0, []
    with open(max(files, key=os.path.getmtime)) as f:
        txt = f.read()
    m = re.search(r"allocation \d+: size \d+, preallocated-temp:(.*?)"
                  r"(?=\nallocation |\Z)", txt, re.S)
    if not m:
        return 0, []
    slots = {}
    for name, sz, off, shape in re.findall(
            r"value: <\d+ ([\w.\-]+) @0> \(size=(\d+),offset=(\d+)\): "
            r"(\S+)", m.group(1)):
        slots.setdefault((int(off), int(sz)), []).append((name, shape))
    total, picked = 0, []
    for (off, sz), vals in slots.items():
        for name, shape in vals:
            if re.match(rf"f32\[{n_layers},", shape) and "convert" in name:
                total += sz
                picked.append(f"{shape} {name} ({sz / 2**20:.0f} MB)")
                break
    return total, picked


def fit_verdict(mem, backend, cpu_artifact_b=0, cpu_artifact_slots=()):
    """The fit-verdict block of a lowering artifact, the same dict the
    reference's ``fit_verdict`` builds from a per-device memory analysis
    ``mem`` (``argument_size_in_bytes``, ``temp_size_in_bytes``).

    TPU backend: the compile succeeding is the verdict (the topology
    compiler enforces ``TPU_BUDGET_GIB``); args+temp is a supplementary
    upper bound.  CPU backend: args+temp resident, minus the XLA:CPU
    bf16-upcast artifact, against a raw 16 GiB budget."""
    if "argument_size_in_bytes" not in mem:
        return {}
    args_b = mem["argument_size_in_bytes"]
    temp_b = mem.get("temp_size_in_bytes", 0)
    resident = args_b + temp_b
    if backend == "tpu":
        return {
            "fits_hbm_compiler_enforced": True,
            "compiler_enforced_budget_gib": TPU_BUDGET_GIB,
            "resident_bytes_per_device_args_plus_temp": resident,
            "resident_gib_per_device_upper_bound": round(
                resident / 2 ** 30, 2),
            "upper_bound_note": "args+temp, ignores donation aliasing "
                                "— the compiler's own scheduler fit is "
                                "the load-bearing verdict",
        }
    corrected = resident - cpu_artifact_b
    return {
        "resident_bytes_per_device_args_plus_temp": resident,
        "resident_gib_per_device": round(resident / 2 ** 30, 2),
        "cpu_bf16_upcast_artifact_bytes": cpu_artifact_b,
        "cpu_bf16_upcast_artifact_gib": round(
            cpu_artifact_b / 2 ** 30, 2),
        "cpu_bf16_upcast_artifact_slots": list(cpu_artifact_slots),
        "resident_gib_corrected_for_cpu_artifact": round(
            corrected / 2 ** 30, 2),
        "hbm_budget_gib": 16.0,
        "fits_16gib_raw_cpu_analysis": bool(resident < 16 * 2 ** 30),
        "fits_16gib_corrected": bool(corrected < 16 * 2 ** 30),
    }
