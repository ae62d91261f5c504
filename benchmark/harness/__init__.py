"""The benchmark's harness: the closed-loop window, the traced run, the
kernel timings and the result line."""
