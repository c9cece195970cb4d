"""What holds kernel 8's warp-specialised bf16 forward back: time it beside
copies of itself with one part of the work taken out, on one CUDA card.

    python scripts/flash_forward_variants.py [--only llama-vision,granite]

Each variant is this checkout's `src` copied under `build/flash_variants/`
with one edit to `csrc/flash_attention.cu` (the edit's anchor must match
the source, or the script stops). Their results are wrong by design: they
only say how much time a part costs.

- `no_kv_reload`: the producer fills each K / V stage once and later only
  arrives on its full barrier, so no K / V bytes move after the ring's
  first round (the products read stale tiles);
- `no_softmax`: the softmax keeps only its scale (no masks, max, ex2, sums);
- `no_exp`: the softmax without its ex2 (p = (x - m) / 2 on the FMA pipe);
- `no_rescale`: O is not rescaled when the row max moves.

The copies build in parallel, then `scripts/flash_forward_probe.py` times
the unmodified copy (`base`) and every variant in turns (base, variants,
base) at the probe's shapes, one JSON line a shape and tree.
"""
import argparse
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CU = pathlib.Path("repro_torch/kernels/csrc/flash_attention.cu")
VARIANTS = {
    "no_kv_reload": (
        "          const uint32_t full = bar(kind, st);\n",
        "          const uint32_t full = bar(kind, st);\n"
        "          if (n >= S) { mbar_arrive(full); return; }\n"),
    "no_softmax": (
        "  const auto softmax = [&](int t) {\n",
        "  const auto softmax = [&](int t) {\n"
        "#pragma unroll\n"
        "    for (int i = 0; i < 64; ++i) s[i] *= scale_log2;\n"
        "    c0 = c1 = 1.0f; m0 = m1 = 0.0f; l0 = l1 = 1.0f;\n"
        "    if (t >= 0) return;\n"),
    "no_exp": (
        "      s[i] = ex2(s[i] - ((i & 2) ? m1 : m0));\n",
        "      s[i] = (s[i] - ((i & 2) ? m1 : m0)) * 0.5f;\n"),
    "no_rescale": (
        "    for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? c1 : c0;\n",
        "    for (int i = 0; i < D / 2; ++i) o[i] *= 1.0f;\n"),
}
LOAD = ("import sys; sys.path.insert(0, sys.argv[1]); "
        "from repro_torch.kernels import _build; _build.load()")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="llama-vision,granite,whisper")
    args = ap.parse_args()
    out = ROOT / "build" / "flash_variants"
    shutil.rmtree(out, ignore_errors=True)
    trees = {}
    for name in ("base", *VARIANTS):
        tree = out / name
        shutil.copytree(ROOT / "src", tree / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        if name in VARIANTS:
            anchor, edit = VARIANTS[name]
            path = tree / "src" / CU
            text = path.read_text()
            if text.count(anchor) != 1:
                print(f"{name}: the anchor is not in {CU} once",
                      file=sys.stderr)
                return 1
            path.write_text(text.replace(anchor, edit))
        trees[name] = tree / "src"
    builds = {name: subprocess.Popen([sys.executable, "-c", LOAD, str(src)])
              for name, src in trees.items()}
    if any(p.wait() for p in builds.values()):
        print("a variant failed to build", file=sys.stderr)
        return 1
    probe = ROOT / "scripts" / "flash_forward_probe.py"
    for name in ("base", *VARIANTS, "base"):
        rc = subprocess.run([sys.executable, str(probe), "--src",
                             str(trees[name]), "--tag", name, "--only",
                             args.only], timeout=600).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
