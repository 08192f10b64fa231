"""The port's logger, ``item_alignment_torch``, formatted as the JAX
package's."""

import logging

logging.basicConfig(
    format="%(asctime)s %(levelname)-4s [%(filename)s:%(lineno)s]  %(message)s",
    datefmt="%Y/%m/%d %H:%M:%S",
    level=logging.INFO,
)

logger = logging.getLogger("item_alignment_torch")
