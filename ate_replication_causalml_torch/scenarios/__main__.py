"""``python -m ate_replication_causalml_torch.scenarios``: the matrix CLI
(the package ``__init__`` imports the module, so this form avoids
runpy's found-in-sys.modules warning)."""

from ate_replication_causalml_torch.scenarios.matrix import main

if __name__ == "__main__":
    main()
