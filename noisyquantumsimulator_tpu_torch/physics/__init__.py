"""Host physics for gate planning: lasers, traps, noise rates, pulses, protocols."""
