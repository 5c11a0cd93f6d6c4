"""A frozen copy of the model layer of lightweaver_tpu_torch (the
atmosphere, the atomic models and their LTE populations, the background
opacities, the broadening and the collisional rates), from which the
reference works out the inputs of its MALI step.  See ../README.md."""
