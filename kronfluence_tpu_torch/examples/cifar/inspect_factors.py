"""Inspect fitted EK-FAC factors: eigenvalue and lambda spectra by module.

Port of `examples/cifar/inspect_factors.py`: loads one module's (or every
module's) activation and gradient eigenvalues and lambda matrix from a factor
directory and prints each spectrum's summary, the text analogue of the
reference's plots.

    python -m kronfluence_tpu_torch.examples.cifar.inspect_factors --factors_name ekfac \
        --module stem/conv --output_dir ./influence_results/cifar
"""

import argparse
from pathlib import Path

import numpy as np

from kronfluence_tpu_torch import Analyzer


def describe(name, values) -> dict:
    """Prints and returns a spectrum's size, max, median, min and the share
    of its mass in its top 1%."""
    values = np.sort(np.asarray(values, dtype=np.float64))[::-1]
    total = values.sum() or 1.0
    top = values[: max(1, len(values) // 100)].sum() / total
    print(f"  {name}: dim={len(values)} max={values[0]:.3e} "
          f"median={np.median(values):.3e} min={values[-1]:.3e} "
          f"top-1%-mass={top:.3f}")
    return {"dim": len(values), "max": float(values[0]), "median": float(np.median(values)),
            "min": float(values[-1]), "top1_mass": float(top)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--factors_name", default="ekfac")
    parser.add_argument("--analysis_name", default="cifar",
                        help="Analyzer name used by detect_mislabeled_dataset")
    parser.add_argument("--module", default=None,
                        help="module name (default: every tracked module)")
    parser.add_argument("--output_dir", default="./influence_results/cifar")
    parser.add_argument("--cpu", action="store_true",
                        help="accepted as by the other scripts; the factors are read on the CPU")
    args = parser.parse_args(argv)

    factor_dir = Path(args.output_dir) / args.analysis_name / f"factors_{args.factors_name}"
    lambda_path = factor_dir / "lambda_matrix.safetensors"
    act_eig_path = factor_dir / "activation_eigenvalues.safetensors"
    grad_eig_path = factor_dir / "gradient_eigenvalues.safetensors"

    lambdas = Analyzer.load_file(lambda_path)
    modules = [args.module] if args.module else sorted(lambdas)
    act_eigs = Analyzer.load_file(act_eig_path) if act_eig_path.exists() else {}
    grad_eigs = Analyzer.load_file(grad_eig_path) if grad_eig_path.exists() else {}

    summaries = {}
    for module in modules:
        print(f"module {module}:")
        summary = summaries[module] = {}
        if module in act_eigs:
            summary["activation"] = describe("activation eigenvalues", act_eigs[module].double())
        if module in grad_eigs:
            summary["gradient"] = describe("gradient eigenvalues", grad_eigs[module].double())
        summary["lambda"] = describe("lambda (eigenbasis second moments)",
                                     lambdas[module].double().ravel())
    return summaries


if __name__ == "__main__":
    main()
