"""One module for each entry of the program that a traffic mix drives:
set-up, the window, the release of the program's state and the readings
that the comparison limits."""
