"""Operations and bytes of the program's kernels and steps, from shapes."""
