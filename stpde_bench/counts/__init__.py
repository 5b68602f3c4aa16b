"""Operations and bytes of the program's work, from shapes."""
