"""The harness: registry, set-up, window, correctness and trace reading."""
