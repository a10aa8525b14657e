"""Operations, exponentials and bytes of each kernel launch and of each
step, counted from shapes alone, and the card's peaks: frozen here so that
no change to the program moves the yardstick."""
