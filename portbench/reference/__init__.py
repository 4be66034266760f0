"""Plain references, one module per model family; they import numpy and torch only."""
