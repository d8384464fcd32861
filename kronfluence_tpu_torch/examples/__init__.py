"""The example pipelines of the port, run as modules:

    python -m kronfluence_tpu_torch.examples.<name>.<script> [--cpu] ...

Ports of the JAX package's `examples/` (cifar, imagenet, openwebtext, uci,
wikitext), on synthetic data made with numpy from a seed; nothing is fetched.
Each script runs on `cuda:0` unless `--cpu` asks for the CPU.
"""
