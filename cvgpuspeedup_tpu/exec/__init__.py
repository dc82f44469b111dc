"""The executor: pipeline build, the compile cache, the divergent launcher."""
