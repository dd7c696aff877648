"""The env names of the engram contract that the port reads: the port's
own copy of the JAX package's names (its ``sdk/contract.py``), not an
import of them. The operator exports these; nothing here reads them."""

ENV_TPU_HOSTS = "BOBRA_TPU_HOSTS"  # host processes in the gang
ENV_TPU_HOST_ID = "BOBRA_TPU_HOST_ID"  # this host's index (0-based)
ENV_COORDINATOR_ADDRESS = "BOBRA_COORDINATOR_ADDRESS"  # the process group's coordinator
ENV_MESH_AXES = "BOBRA_MESH_AXES"  # JSON {axis: size}

# multi-grant (spanning gang): each member's replica identity and the
# span-global process layout, so every process of every member joins one
# process group and builds the two-level dcn x inner mesh
ENV_DCN_REPLICAS = "BOBRA_DCN_REPLICAS"  # DCN axis size (span member count)
ENV_DCN_REPLICA_INDEX = "BOBRA_DCN_REPLICA_INDEX"  # this member's index
ENV_SPAN_ID = "BOBRA_SPAN_ID"  # spanning-grant group id
ENV_SPAN_PROCESSES = "BOBRA_SPAN_PROCESSES"  # global process count
ENV_SPAN_PROCESS_BASE = "BOBRA_SPAN_PROCESS_BASE"  # first global process id here
