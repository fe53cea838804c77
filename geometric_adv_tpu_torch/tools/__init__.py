"""Scripts over a finished run's artifacts (``tools/`` of the repo):
``compare_frozen`` and ``frozen_exact_reeval``."""
