"""Static analysis + program auditing + runtime sanitizers for the port.

Port of `dorpatch_tpu.analysis`, with these wings:

- **AST** (`engine.py`, `rules_output.py`, `rules_torch.py`, `fix.py`,
  `cli.py`): rules DP101-DP108 (each JAX rule's torch reading) with stable
  IDs, `# noqa: DPxxx` suppressions, a mechanical DP106 fixer (`--fix`),
  and the CLI gate `python -m dorpatch_tpu_torch.analysis`.
- **Concurrency** (`concurrency.py`, `--concurrency`): rules DP500-DP504
  over the threaded packages, and `static_lock_graph()`, the DP501 graph
  the runtime lock watch is seeded with.
- **Trace** (`entrypoints.py`, `program.py`, `--trace`): rules DP200-DP208
  over the graph of every production entry point, traced on fake tensors
  (`make_fx`; each kernel one `dorpatch_torch::` op).
- **Baseline** (`baseline.py`, `--baseline check|update`): rules
  DP300-DP304 comparing every entry point's graph fingerprint, interface
  and static cost vector against the checked-in `baselines.json`.
- **Runtime** (`sanitize.py`, `lockwatch.py`): the `--sanitize` flag.

DP305 (the AOT store's drift against the baseline) is reported by
`python -m dorpatch_tpu_torch.aot verify`. The comms wing (DP600-DP603)
is not ported yet. Importing the
package, the engine, the AST rules or the CLI loads no torch (the
re-certification and gateway CLIs emit findings through it); the trace
and baseline wings import torch when they run.
"""

from dorpatch_tpu_torch.analysis.engine import (  # noqa: F401
    ALL_CODES,
    FileContext,
    Finding,
    Rule,
    all_rules,
    analyze_file,
    analyze_paths,
    analyze_source,
    get_rule,
    iter_python_files,
    register,
)

__all__ = [
    "ALL_CODES",
    "FileContext",
    "Finding",
    "Rule",
    "all_rules",
    "analyze_file",
    "analyze_paths",
    "analyze_source",
    "get_rule",
    "iter_python_files",
    "register",
]

