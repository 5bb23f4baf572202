"""One reader a metric: ``<name>.py`` holds ``read(run)`` (see
``perfbench.harness.RunData``) and, for a share of a peak, its own
reckoning of operations and bytes."""
