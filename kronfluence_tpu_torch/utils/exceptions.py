"""Framework exceptions (parity with reference kronfluence/utils/exceptions.py)."""


class KronfluenceTPUError(Exception):
    """Base class for all framework errors."""


class FactorsNotFoundError(KronfluenceTPUError):
    """Raised when requested factors cannot be found on disk."""


class TrackedModuleNotFoundError(KronfluenceTPUError):
    """Raised when no tracked module could be discovered in the model."""


class IllegalTaskConfigurationError(KronfluenceTPUError):
    """Raised when the Task is configured in an unsupported way."""


class UnsupportableModuleError(KronfluenceTPUError):
    """Raised when a module cannot be tracked (e.g., exotic conv config)."""
