"""Build text-substituted variants of a kernel source, for ablations.

A spec (JSON) maps a variant's name to a list of ``[old, new]`` text
substitutions (an empty list is the source as it stands).  Each
substitution applies to the one file that holds ``old``, of the kernel's
``csrc/<source>.cu`` and the shared ``csrc/*.cuh``; the variant's copies
are built by nvcc with the package's flags beside the package's build
(``_build/variants/<source>_<name>/``).  ``tools/dyn_times.py`` and
``tools/seg_times.py`` time the libraries in turns.
"""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def build_variants(spec, names, source):
    """nvcc each named variant of ``csrc/<source>.cu``, all at once;
    return {name: library path}."""
    sys.path.insert(0, str(ROOT))
    from libpll_tpu_torch.ops import _build

    unknown = sorted(set(names) - set(spec))
    if unknown:
        raise SystemExit(f"variants not in the spec: {', '.join(unknown)}")
    files = [_build.CSRC_DIR / f"{source}.cu",
             *sorted(_build.CSRC_DIR.glob("*.cuh"))]
    jobs = {}
    for name in dict.fromkeys(names):
        texts = {f.name: f.read_text() for f in files}
        for old, new in spec[name]:
            holders = [f for f, t in texts.items() if old in t]
            if len(holders) != 1:
                raise SystemExit(f"variant {name}: {old!r} is in "
                                 f"{len(holders)} sources, not one")
            texts[holders[0]] = texts[holders[0]].replace(old, new)
        folder = _build.BUILD_DIR / "variants" / f"{source}_{name}"
        shutil.rmtree(folder, ignore_errors=True)
        folder.mkdir(parents=True)
        for fname, text in texts.items():
            (folder / fname).write_text(text)
        lib = folder / f"{source}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(folder),
             "-o", str(lib), str(folder / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs, failed = {}, []
    for name, (lib, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"variant {name} does not build:\n{stderr}")
            continue
        print(f"variant {name}: {', '.join(ptxas_usage(stdout + stderr))}",
              flush=True)
        libs[name] = lib
    if failed:
        raise SystemExit("\n".join(failed))
    return libs


def ptxas_usage(log):
    """Each kernel's "N registers" (", S B spilled" where it spills) from
    nvcc's -Xptxas -v output, in the order compiled."""
    usage, spill = [], 0
    for line in log.splitlines():
        if "bytes spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        if "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split(",")[0].strip()
            usage.append(regs + (f", {spill} B spilled" if spill else ""))
            spill = 0
    return usage


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
