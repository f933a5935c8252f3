"""Where K12's time goes inside a call: SM cycles a Jacobi round.

    python tools/diag_k12_rounds.py [--out chiprun_out/diag_k12_rounds]

Writes a copy of ``sift_pyocl_tpu_torch/csrc/linalg.cu`` with two more
kernels made from ``sym_eig_small_kernel``'s source: ``stamped``, the
kernel with ``clock64()`` read by lane 0 of matrix 0 at the start of the
call, of every round, after the loop and after V's replay; and
``no_angle``, the same with each lane's two rotations replaced by a fixed
stand-in (every pair "rotates" by the same (c, s), so the loop runs all
MAX_SWEEPS sweeps): its cycles a round are what a round costs besides the
angle's chain.  Builds them with nvcc (the package's flags) into a
program that runs each at batches of 1 and 257 on K12's inputs
(``chip_smoke.linalg_scene``'s eight-point A^T A, written to a file) and
prints event ms a call, sweeps, cycles from the start to the loop, a round
(mean and the first 18), and after the loop, beside the card's name and
power limit.  Requires nvcc and a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MAIN = r"""
#include <cstdio>
#include <vector>

template <typename F>
float time_ms(F f, int iters) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int i = 0; i < 3; ++i) f();
  cudaEventRecord(e0);
  for (int i = 0; i < iters; ++i) f();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms / iters;
}

int main(int argc, char** argv) {
  const int N = 9;
  std::vector<float> h;
  FILE* f = fopen(argv[1], "rb");
  float x;
  while (fread(&x, 4, 1, f) == 1) h.push_back(x);
  fclose(f);
  const int B = (int)h.size() / (N * N);
  float *a, *w, *v;
  long long* clk;
  cudaMalloc(&a, h.size() * 4);
  cudaMalloc(&w, B * N * 4);
  cudaMalloc(&v, B * N * N * 4);
  cudaMalloc(&clk, 2048 * 8);
  cudaMemcpy(a, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
  for (int batch : {1, B}) {
    const int blocks = (batch + EIG_WARPS - 1) / EIG_WARPS;
    for (int var = 0; var < 2; ++var) {
      auto run = [&] {
        if (var == 0) stamped<9><<<blocks, 32 * EIG_WARPS>>>(a, w, v, batch, clk);
        else no_angle<9><<<blocks, 32 * EIG_WARPS>>>(a, w, v, batch, clk);
      };
      const float ms = time_ms(run, 50);
      cudaMemset(clk, 0, 2048 * 8);
      run();
      std::vector<long long> c(2048);
      cudaMemcpy(c.data(), clk, 2048 * 8, cudaMemcpyDeviceToHost);
      const int rounds = (int)c[1001] * 9;
      printf("%s batch %d: %.4f ms a call (events); sweeps with rotations %lld; cycles: start "
             "to loop %lld, a round %.1f, after the loop %lld; first rounds",
             var ? "no_angle" : "stamped", batch, ms, c[1001], c[0] - c[1003],
             rounds ? (c[1000] - c[0]) / (double)rounds : 0.0, c[1002] - c[1000]);
      for (int i = 1; i < rounds && i < 19; ++i) printf(" %lld", c[i] - c[i - 1]);
      printf("\n");
    }
  }
  printf("error: %s\n", cudaGetErrorString(cudaDeviceSynchronize()));
  return 0;
}
"""


def variants(src: str) -> str:
    """linalg.cu with the stamped and no_angle kernels appended."""
    a = src.index("template <int N>\n__global__ void __launch_bounds__(32 * EIG_WARPS) "
                  "sym_eig_small_kernel(")
    body = src[a:src.index("template <int N>\ncudaError_t launch_eig")]
    edits = [
        ("int batch) {", "int batch, long long* clk) {"),
        ("  const int lane = threadIdx.x & 31;\n",
         "  const int lane = threadIdx.x & 31;\n"
         "  if (blockIdx.x == 0 && threadIdx.x == 0) clk[1003] = clock64();\n"),
        ("    for (int r = 0; r < M; ++r) {\n",
         "    for (int r = 0; r < M; ++r) {\n"
         "      if (b == 0 && lane == 0) clk[sweeps * M + r] = clock64();\n"),
        ("  // rank of each eigenvalue",
         "  if (b == 0 && lane == 0) {\n    clk[1000] = clock64();\n    clk[1001] = sweeps;\n  }\n"
         "  // rank of each eigenvalue"),
        ("  float* vo = v_out +", "  if (b == 0 && lane == 0) clk[1002] = clock64();\n"
                                 "  float* vo = v_out +"),
    ]
    for old, new in edits:
        assert body.count(old) >= 1, old
        body = body.replace(old, new, 1)
    stamped = body.replace("sym_eig_small_kernel(", "stamped(")
    lo = body.index("      bool goP = eig_rotation_fast(")
    hi = body.index("      int pn, qn, un, xn;")
    no_angle = (body[:lo].replace("sym_eig_small_kernel(", "no_angle(")
                + "      const bool goP = !bye_p, goQ = !bye_q;\n"
                  "      cP = cQ = 0.99995f;\n      sP = sQ = 0.01f;\n      tP = tQ = 0.0100005f;\n"
                  "      (void)okP;\n      (void)okQ;\n" + body[hi:])
    return src + "\nnamespace {\n" + stamped + no_angle + "}\n" + MAIN


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "diag_k12_rounds"))
    args = ap.parse_args()
    import chip_smoke as cs
    from sift_pyocl_tpu_torch.ops import _build

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    src = (ROOT / "sift_pyocl_tpu_torch" / "csrc" / "linalg.cu").read_text()
    (out / "rounds.cu").write_text(variants(src))
    cs.linalg_scene("cpu")[0].numpy().astype("float32").tofile(out / "inputs.f32")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc_path(), *flags, "-o", str(out / "rounds"), str(out / "rounds.cu")],
                   check=True, capture_output=True)
    print(cs.nvidia_smi_line(), flush=True)
    return subprocess.run([str(out / "rounds"), str(out / "inputs.f32")], check=False).returncode


if __name__ == "__main__":
    sys.exit(main())
