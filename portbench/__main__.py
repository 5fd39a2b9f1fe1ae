import sys

from portbench.bench import main

sys.exit(main())
