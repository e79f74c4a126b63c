"""Lindblad propagators and the real Hermitian-basis phase-frame scan."""
