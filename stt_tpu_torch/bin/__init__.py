"""The port's counterparts of the repository's bin/ scripts: the shell
recipes that train, evaluate, export and serve on LDC93S1
(run-ldc93s1.sh, run-ci-ldc93s1_*.sh), multi-process training
(run-ci-multihost.sh), the flagship endurance recipe
(run-flagship-endurance.sh), and make_spliced_corpus.py, which it runs.
Each script takes the variable `device` (default cuda) and passes it as
--device to every command that computes."""
