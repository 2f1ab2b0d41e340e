"""Built-in lint rules.

``ALL_RULES`` is the one registry the CLI and the tests resolve rules
through; add a new rule module here and it runs everywhere at once.
"""

from repro_torch.analysis.rules.kernel_containment import \
    KernelContainmentRule
from repro_torch.analysis.rules.register_path_decl import RegisterPathDeclRule
from repro_torch.analysis.rules.retired_names import RetiredNamesRule
from repro_torch.analysis.rules.thin_cli import ThinCliRule
from repro_torch.analysis.rules.wall_clock import WallClockRule

ALL_RULES = (
    ThinCliRule(),
    RetiredNamesRule(),
    KernelContainmentRule(),
    WallClockRule(),
    RegisterPathDeclRule(),
)

__all__ = ["ALL_RULES", "ThinCliRule", "RetiredNamesRule",
           "KernelContainmentRule", "WallClockRule", "RegisterPathDeclRule"]
