"""The resource-management substrate the cap-only engine reads: the cluster
datamodel, the dense slot layout, and the entitlement waterfill."""
