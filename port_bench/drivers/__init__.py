"""One module for each entry of the program that a traffic mix drives:
set-up, the window, the release of the program's state and the readings
that the comparison limits; and for the CPU tests its tiny cut (`TINY`)
and the faults that it plants in the program (`FAULTS`)."""
