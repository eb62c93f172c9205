"""The port's diagnostic and analysis scripts, counterparts of the JAX
package's ``scripts/`` of the same names and flags:

    python -m stmask_torch.scripts.<name> [flags] [--device cpu]

Each splits into an importable ``run(...)``, which the tests call at a
reduced config, and an argparse ``main(argv=None)``.  A script that runs
the model does so on ``--device`` (default ``cuda``, which raises without a
GPU); the card runs the hand-written kernels, the CPU their plain versions.
Every module imports only the standard library, numpy and torch at import
time, and the package's modules inside its functions.
"""
