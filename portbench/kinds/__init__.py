"""Request families: each traffic mix names one in its ``kind``."""
