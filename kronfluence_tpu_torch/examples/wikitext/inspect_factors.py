"""Inspect fitted EK-FAC factors: spectra, conditioning, per-module lambda mass.

Port of `examples/wikitext/inspect_factors.py`: loads the persisted factor
artifacts and prints a per-module table (largest activation eigenvalue,
condition numbers, mean lambda, the share of lambda above a 0.1 x mean
damping), and optionally saves the spectra as .npy for plotting.

    python -m kronfluence_tpu_torch.examples.wikitext.inspect_factors --factors_dir ./influence_results/wikitext/wikitext/factors_ekfac
"""

import argparse
from pathlib import Path

import numpy as np

from kronfluence_tpu_torch import Analyzer


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--factors_dir", required=True)
    parser.add_argument("--dump_spectra", default=None, help="dir to save .npy spectra")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    d = Path(args.factors_dir)
    act_evals = Analyzer.load_file(d / "activation_eigenvalues.safetensors")
    grad_evals = Analyzer.load_file(d / "gradient_eigenvalues.safetensors")
    lam = Analyzer.load_file(d / "lambda_matrix.safetensors")
    num = Analyzer.load_file(d / "num_lambda_processed.safetensors")

    rows = {}
    print(f"{'module':<28} {'act λmax':>10} {'act cond':>10} {'grad cond':>10} {'Λ mean':>10} "
          f"{'Λ>damp %':>9}")
    for name in sorted(act_evals):
        a = act_evals[name].double().numpy()
        g = grad_evals[name].double().numpy()
        l = lam[name].double().numpy() / float(num[name].reshape(()).item())
        eps = 1e-12
        a_cond = float(a.max() / max(a.min(), eps * a.max()))
        g_cond = float(g.max() / max(g.min(), eps * g.max()))
        damping = 0.1 * l.mean()
        frac = float((l > damping).mean())
        rows[name] = (float(a.max()), a_cond, g_cond, float(l.mean()), frac)
        print(f"{name:<28} {a.max():>10.3g} {a_cond:>10.3g} {g_cond:>10.3g} "
              f"{l.mean():>10.3g} {100 * frac:>8.1f}%")
        if args.dump_spectra:
            out = Path(args.dump_spectra)
            out.mkdir(parents=True, exist_ok=True)
            np.save(out / f"{name.replace('/', '_')}_act_evals.npy", a)
            np.save(out / f"{name.replace('/', '_')}_grad_evals.npy", g)
    if args.dump_spectra:
        print(f"spectra saved under {args.dump_spectra}")
    return rows


if __name__ == "__main__":
    main()
