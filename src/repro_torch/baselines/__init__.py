"""The paper's baselines on the packed parameter plane."""
