"""Data-parallel training over several processes, one rank per device."""
